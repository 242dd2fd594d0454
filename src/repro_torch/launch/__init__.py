"""Launch scripts of the port (``launch/train.py``; ``src/repro/launch``'s
others wait for ROADMAP §1 item 4)."""
