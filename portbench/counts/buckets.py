"""The gradient sync's fusion buckets, frozen: which leaves share a bucket
and how many elements and int8 rows each bucket has.

Leaves are packed in the parameter tree's flatten order (keys sorted at
every level) into buckets of at most ``limit_mb`` MiB counted in the
leaves' own dtype; a leaf that does not fit closes the bucket, and a leaf
larger than the limit has a bucket of its own.  A bucket travels as f32,
zero-padded to a whole number of 64 rows of 256 for the int8 codec.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

PAD_UNIT = 256 * 64


def plan(sizes: Sequence[int], itemsize: int, limit_mb: float = 64.0) -> List[List[int]]:
    """Leaf indices of each bucket, in order."""
    limit = int(limit_mb * 1024 * 1024)
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, size in enumerate(sizes):
        nbytes = size * itemsize
        if cur_bytes > 0 and cur_bytes + nbytes > limit:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def bucket_elements(sizes: Sequence[int], itemsize: int,
                    limit_mb: float = 64.0) -> List[Tuple[int, int]]:
    """(elements, int8 rows after padding) of each bucket."""
    out = []
    for leaves in plan(sizes, itemsize, limit_mb):
        n = sum(sizes[i] for i in leaves)
        out.append((n, -(-n // PAD_UNIT) * PAD_UNIT // 256))
    return out
