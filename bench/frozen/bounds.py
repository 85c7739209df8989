"""The least time a kernel call could take on the card: the bytes it
must move over the HBM rate, or the operations it must do over the
peak for its input type, whichever is larger.  Each input byte is read
once and each output byte written once; operations are those the
inputs need, whatever a kernel computes twice."""
from __future__ import annotations

from frozen.peaks import HBM_BYTES_PER_S, PEAK_OPS_PER_S

_SIZES = {"float": 4, "float32": 4, "c10::BFloat16": 2, "bfloat16": 2,
          "c10::Half": 2, "half": 2, "double": 8, "int": 4, "long int": 8}


def nbytes(shape, dtype: str) -> int:
    n = 1
    for s in shape:
        n *= s
    return n * _SIZES[dtype]


def bound_s(n_bytes: float, n_ops: float, kind: str) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[kind])


def kind_of(dtype: str) -> str:
    return "fp32" if _SIZES[dtype] == 4 else "bf16"


def flash_bound_s(q_shape, k_shape, dtype: str, causal: bool = True) -> float:
    """Attention q (B, Sq, H, hd) over k/v (B, Sk, KV, hd): 4·hd
    operations a (query, key) pair a head, the pairs a causal mask
    keeps; bytes: q, k and v read, the output written."""
    B, Sq, H, hd = q_shape
    Sk = k_shape[1]
    pairs = Sq * (Sq + 1) // 2 + Sq * (Sk - Sq) if causal else Sq * Sk
    n_ops = 4 * hd * B * H * pairs
    n_bytes = 2 * nbytes(q_shape, dtype) + 2 * nbytes(k_shape, dtype)
    return bound_s(n_bytes, n_ops, kind_of(dtype))


def ssd_bound_s(shapes, dtypes) -> float:
    """The intra-chunk SSD term, inputs x (BC, Q, nh, hd), dt, dacs
    (BC, Q, nh), b, c (BC, Q, g, ds): C·Bᵀ once a (chunk, group), then
    M·X, M's decay and its scale a head, over the causal pairs; bytes:
    the five inputs read, y (x's shape and type) written."""
    (BC, Q, nh, hd), b_shape = shapes[0], shapes[3]
    g, ds = b_shape[-2:]
    pairs = BC * Q * (Q + 1) // 2
    n_ops = pairs * (g * 2 * ds + nh * (2 * hd + 4))
    n_bytes = sum(nbytes(s, t) for s, t in zip(shapes[:5], dtypes[:5])) \
        + nbytes(shapes[0], dtypes[0])
    return bound_s(n_bytes, n_ops, kind_of(dtypes[0]))
