"""The runnable examples of the port, one for each of the JAX package's
``examples/`` scripts, with the same sizes, pipelines and printed lines:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.ltr_experiment
    PYTHONPATH=src python -m repro_torch.examples.serve_pipeline
    PYTHONPATH=src python -m repro_torch.examples.train_lm [--preset 100m]

Each runs on the card unless ``--device`` says otherwise; its work is a
``run`` function that ``main`` calls and that returns what it printed.
"""
