"""LM substrate of the port: counterpart of ``repro.models``."""
