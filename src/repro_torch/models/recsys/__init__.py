"""The recsys models of the zoo (the port of ``src/repro/models/recsys``):
DCN-v2, AutoInt, DIEN and MIND over the shared embedding substrate."""
