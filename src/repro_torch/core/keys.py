"""Random keys for the randomized SVD sketch.

The reference threads ``jax.random`` keys through every randomized solve.
Torch cannot reproduce JAX's streams, so the port draws its sketches and
the VQE ensembles' member streams from a **key object** with these methods:

* ``split(n)`` — a list of ``n`` independent child keys;
* ``fold_in(i)`` — the child key of integer ``i`` (``jax.random.fold_in``);
* ``sketch(shape, dtype, device)`` — a uniform ``[-1, 1)`` tensor, complex
  as ``re + 1j * im`` (the reference's ``rsvd._random_sketch``);
* ``uniform(shape, lo, hi, dtype, device)`` — a uniform ``[lo, hi)`` real
  tensor (``jax.random.uniform``);
* ``rademacher(shape, dtype, device)`` — random signs +-1
  (``jax.random.rademacher``).

Every place the reference splits or folds keys keeps the same structure in
the port, so a key object backed by ``jax.random`` (the parity tests build
one) reproduces the reference's draws exactly.  :class:`TorchKey` is the
port's own: a 64-bit seed whose children come from a splitmix64 mix and
whose draws come from a ``torch.Generator`` on the target device.  Its
sketch always draws float32 numbers and casts them, so one key gives the
same sketch at every precision: a complex64 and a complex128 run of the
same contraction differ only by rounding, not by their random subspaces.
"""
from __future__ import annotations

from typing import List

import torch

_MASK64 = (1 << 64) - 1
# offsets fold_in's children from split's, which mix the same seed
_FOLD = 0xD1B54A32D192ED03


def _mix64(seed: int, i: int) -> int:
    """splitmix64 of ``seed`` advanced by ``i + 1`` golden-ratio steps."""
    z = (seed + (i + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class TorchKey:
    """Counter-style key: an integer seed, children by splitmix64."""

    def __init__(self, seed: int):
        self.seed = int(seed) & _MASK64

    def __repr__(self) -> str:
        return f"TorchKey({self.seed:#x})"

    def split(self, n: int) -> List["TorchKey"]:
        return [TorchKey(_mix64(self.seed, i)) for i in range(n)]

    def fold_in(self, i: int) -> "TorchKey":
        return TorchKey(_mix64(self.seed ^ _FOLD, int(i)))

    def _generator(self, device) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        return gen

    def uniform(self, shape, lo: float, hi: float, dtype: torch.dtype,
                device) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self._generator(device),
                       dtype=dtype, device=device)
        return lo + (hi - lo) * u

    def rademacher(self, shape, dtype: torch.dtype, device) -> torch.Tensor:
        bits = torch.randint(0, 2, tuple(shape),
                             generator=self._generator(device), device=device)
        return (2 * bits - 1).to(dtype)

    def sketch(self, shape, dtype: torch.dtype, device) -> torch.Tensor:
        gen = self._generator(device)

        def uniform():
            u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                           device=device)
            return 2.0 * u - 1.0

        if dtype.is_complex:
            re = uniform()
            return torch.complex(re, uniform()).to(dtype)
        return uniform().to(dtype)


def key_or_default(key, seed: int):
    """``key`` itself, or a :class:`TorchKey` of ``seed`` when it is None."""
    return TorchKey(seed) if key is None else key
