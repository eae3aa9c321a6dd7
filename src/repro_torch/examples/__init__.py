"""Runnable examples of the port, counterparts of the repository's
`examples/quickstart.py` and `examples/msc_pipeline.py`:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.msc_pipeline [--device cpu]
"""
