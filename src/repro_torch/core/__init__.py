"""Core paper contribution: RFF, RF-TCA, decomposable MMD (PyTorch port)."""
