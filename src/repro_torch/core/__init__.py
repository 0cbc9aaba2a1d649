"""Core PEPS library of the port (counterpart of :mod:`repro.core`).

Unlike the reference, importing this package flips no global dtype default:
every constructor takes an explicit ``dtype`` (complex128 by default) and
``device`` (the CUDA card by default).
"""
