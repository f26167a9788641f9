"""The process-global random stream (``paddle_tpu/core/random.py``
counterpart): :func:`seed` resets it, :func:`next_key` draws from it.

The reference folds jax PRNG keys; the port draws integer seeds for
``torch.Generator`` instead, each a hash of the values folded in
(:func:`fold_in`).  Streams are reproducible within the port, not
bit-equal to the reference's jax draws (ROADMAP.md, rules of the port).
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["fold_in", "next_key", "seed"]

_GLOBAL_SEED = [0]
_EAGER_COUNTER = [0]


def fold_in(*values: int) -> int:
    """A generator seed that is a pure function of ``values`` (63 bits of
    their blake2b hash)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(np.asarray(values, np.int64).tobytes())
    return int.from_bytes(h.digest(), "little") & 0x7FFFFFFFFFFFFFFF


def seed(s: int) -> None:
    """``paddle.seed`` parity: reset the process-global random stream."""
    _GLOBAL_SEED[0] = int(s)
    _EAGER_COUNTER[0] = 0


def next_key() -> int:
    """Draw the next seed of the global stream."""
    _EAGER_COUNTER[0] += 1
    return fold_in(_GLOBAL_SEED[0], _EAGER_COUNTER[0])
