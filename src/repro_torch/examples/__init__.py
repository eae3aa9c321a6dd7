"""Runnable examples of the port, counterparts of the repository's
`examples/*.py`:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.msc_pipeline [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
"""
