"""The benchmark's plain reference: the semantics of the cells' pipelines
worked out again from the raw corpus and weights, in plain PyTorch.  It
imports nothing of the system under test."""
