"""The loops that drive the program, one module a traffic ``driver``."""
