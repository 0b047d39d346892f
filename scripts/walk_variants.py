"""Variants of the batched gather loop ``csrc/carry.cuh::walk_edges``, for
the A/B scripts of kernel rows 8 and 2 (``scripts/row8_ab.py``,
``scripts/row2_ab.py``).  Each function takes the header's text and returns
it with the gather loop replaced; the fold order (edge order) is kept, so
every variant gives the same bits:

  * ``guarded``: a batch gathers only its edges before the round's end (each
    load under ``u0 + u < n_here``) in place of loading the last edge again;
  * ``unrolled``: one edge at a time under ``#pragma unroll 4``, the first
    ports' loop without their ``if (active)`` (a lane past K reads column 0).

``with_header`` writes a copy of ``csrc/``'s headers with ``carry.cuh``
replaced and returns the directory to put on the include path.
"""

import os
import shutil

LOOP = """    int u0 = 0;
    if constexpr (TAIL < BATCH) {
      for (; u0 + BATCH <= n_here; u0 += BATCH)
        gather_fold<T, VEC, SW, BATCH, HAS_VALS>(w, u0, n_here, c, v, col, K,
                                                 fold);
    }
    for (; u0 < n_here; u0 += TAIL)
      gather_fold<T, VEC, SW, TAIL, HAS_VALS>(w, u0, n_here, c, v, col, K,
                                              fold);
"""
LOAD = """    p[u] = *reinterpret_cast<const P*>(col + (int64_t)w.get(c, j) * K);
"""


def _replace(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, old
    return src.replace(old, new)


def guarded(src: str) -> str:
    return _replace(src, LOAD, """    const int cj = w.get(c, j);
    if (u0 + u < n_here)
      p[u] = *reinterpret_cast<const P*>(col + (int64_t)cj * K);
""")


def unrolled(src: str) -> str:
    return _replace(src, LOOP, """#pragma unroll 4
    for (int j = 0; j < n_here; ++j) {
      const float vj = HAS_VALS ? w.get(v, j) : 1.f;
      fold(vj, *reinterpret_cast<const Pack<T, VEC>*>(
                   col + (int64_t)w.get(c, j) * K));
    }
""")


def with_header(csrc: str, carry: str, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(csrc):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, name), out_dir)
    with open(os.path.join(out_dir, "carry.cuh"), "w") as fh:
        fh.write(carry)
    return out_dir
