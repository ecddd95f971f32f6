"""The reference's TPU tile-size parameters at the port's kernel entries.

The reference's kernel functions take Pallas block sizes (`block_rows`,
`block_q`, `block_k`, `block_n`) at fixed positions. The port's entries
keep those parameters at the same positions, so a call shaped like the
reference's binds every other argument to the same meaning; the CUDA
kernels choose their own tiles, so a tile size takes None and any other
value raises, naming the difference."""
from __future__ import annotations


def refuse_tiles(entry, **tiles):
    """Raise ValueError where any of `tiles` (name -> value) is not None."""
    given = {k: v for k, v in tiles.items() if v is not None}
    if given:
        named = ", ".join(f"{k}={v!r}" for k, v in given.items())
        raise ValueError(
            f"{entry}: {named}: the reference's TPU tile sizes; the port's "
            f"CUDA kernels choose their own tiles, so these take None")
