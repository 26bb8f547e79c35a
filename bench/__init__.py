"""The benchmark of the PyTorch port (``repro_torch``): harness, inputs,
plain reference and the yardstick's arithmetic. See ``run.py``."""
