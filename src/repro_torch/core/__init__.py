"""Core PEPS library of the port (counterpart of :mod:`repro.core`).

Unlike the reference, importing this package flips no global dtype default:
every constructor takes an explicit ``dtype`` (complex128 by default) and
``device`` (the CUDA card by default).
"""

from repro_torch.core.peps import PEPS, computational_zeros, random_peps  # noqa: F401
from repro_torch.core.gates import GATES, gate, two_site_gate  # noqa: F401
from repro_torch.core.observable import Observable  # noqa: F401
from repro_torch.core.einsumsvd import DirectSVD, RandomizedSVD, einsumsvd  # noqa: F401
