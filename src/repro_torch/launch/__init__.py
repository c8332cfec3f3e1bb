"""Entry points of the LM backbone, ported from ``repro.launch``."""
