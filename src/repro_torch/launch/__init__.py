"""Launch scripts of the port (``launch/train.py``, and of
``launch/steps.py`` the model-FLOP formulas and the recsys input table;
``src/repro/launch``'s others wait for ROADMAP §1 item 4)."""
