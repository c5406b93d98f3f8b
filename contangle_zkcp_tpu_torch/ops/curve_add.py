"""K3 (complete G1 point add) and K5c (its tensor-core variant): wrappers
and twins.

Port of `contangle_zkcp_tpu/ops/pallas_curve.py` (`PallasSWAdd.add_t`,
body `rcb_add_body`): the Renes-Costello-Batina complete projective
addition for y^2 = x^3 + b over a prime field, with the constant 3b in
Montgomery form.  Points are three `(n, L)` int32 coordinate planes.

The wrapper launches kernel K3 for CUDA tensors at any batch size and
takes the twin only for CPU tensors.  The twin is the same formula over
the limb-major Montgomery multiply and modular add/sub of `ops/mont.py`.

The kernels have two arithmetics (csrc/fp_lazy.cuh), which `kernel_b3`
picks from p alone: values lazily reduced in [0, 2p) where 4p < R
(BLS12-381 and BN254 Fq, the G1 fields of the Groth16 path), and values
canonical after every operation for any other field (the Pasta fields,
whose Vesta adds the PLONKish IPA runs, and secp256k1's); the strict
instances are built for W = 8.  When 3b is 9 or 12 (BN254, BLS12-381)
the lazy kernels multiply by it with additions, from the curve constant
alone.
"""

from __future__ import annotations

import torch

from . import cuda_lib, mont_mma
from .mont import _words, add_rows, check_operands, from_cols, mont_rows, sub_rows, to_cols, words


def rcb_add_plain(F, b3m: int, P, Q, mont=mont_rows):
    """Plain torch RCB complete addition, a = 0.

    P = (X1, Y1, Z1), Q = (X2, Y2, Z2) as (n, L) planes; b3m is 3b in
    Montgomery form (3b R mod p) as a host int; `mont` is the limb-major
    Montgomery product (K1's twin, or K5a's for K5c).  Returns (X3, Y3,
    Z3)."""
    X1, Y1, Z1, X2, Y2, Z2 = (to_cols(t) for t in (*P, *Q))
    p = F.const("p", X1.device).to(torch.int64)[:, None]
    b3 = to_cols(F.encode(b3m, mont=False, device=X1.device)[None]).expand(X1.shape)

    def mul(x, y):
        return mont(F, x, y)

    def add(x, y):
        return add_rows(x, y, p)

    def sub(x, y):
        return sub_rows(x, y, p)

    t0 = mul(X1, X2)
    t1 = mul(Y1, Y2)
    t2 = mul(Z1, Z2)
    t3 = sub(mul(add(X1, Y1), add(X2, Y2)), add(t0, t1))  # X1Y2 + X2Y1
    t4 = sub(mul(add(Y1, Z1), add(Y2, Z2)), add(t1, t2))  # Y1Z2 + Y2Z1
    y3p = sub(mul(add(X1, Z1), add(X2, Z2)), add(t0, t2))  # X1Z2 + X2Z1
    t2b = mul(b3, t2)
    y3b = mul(b3, y3p)
    Z3p = add(t1, t2b)
    t1p = sub(t1, t2b)
    t0p = add(add(t0, t0), t0)  # 3 X1X2
    X3 = sub(mul(t3, t1p), mul(t4, y3b))
    Y3 = add(mul(t1p, Z3p), mul(y3b, t0p))
    Z3 = add(mul(Z3p, t4), mul(t0p, t3))
    return from_cols(X3), from_cols(Y3), from_cols(Z3)


def rcb_add_mma_plain(F, b3m: int, P, Q):
    """K5c's plain torch version: the same formula over K5a's twin."""
    return rcb_add_plain(F, b3m, P, Q, mont=mont_mma.mont_rows_mma)


SMALL_B3 = (9, 12)  # 3b values the lazy kernels multiply by with an addition chain


def kernel_b3(F, b3m: int):
    """The kernels' curve-constant arguments: (3b R mod p as words, the
    integer 3b when the kernels multiply by it with an addition chain,
    else 0, and the arithmetic: 0 lazy, 1 strict).  The arithmetic follows
    from p alone: lazy reduction in [0, 2p) needs 4p < R (BLS12-381 and
    BN254 Fq); any other field (the Pasta fields, secp256k1's) takes the
    strict arithmetic, canonical after every operation, with the general
    multiply by 3b."""
    cache = F.__dict__.setdefault("_kernel_b3", {})
    if b3m not in cache:
        strict = int(4 * F.p >= F.R)
        b3 = b3m * pow(F.R, -1, F.p) % F.p
        cache[b3m] = (words(F, b3m), b3 if b3 in SMALL_B3 and not strict else 0, strict)
    return cache[b3m]


def sw_add(F, b3m: int, P, Q):
    """K3: P + Q for (n, L) int32 coordinate planes (canonical Montgomery
    limbs); b3m is 3b R mod p, the curve constant in Montgomery form.
    K5c under ZKCP_MXU=1."""
    if mont_mma.use_mxu():
        return sw_add_mma(F, b3m, P, Q)
    n = check_operands(F, *P, *Q)
    if not P[0].is_cuda:
        return rcb_add_plain(F, b3m, P, Q)
    out = tuple(torch.empty_like(P[0]) for _ in range(3))
    if n == 0:
        return out
    p, n0 = _words(F)
    b3w, b3small, strict = kernel_b3(F, b3m)
    rc = cuda_lib.lib().k3_sw_add(
        *(t.data_ptr() for t in P), *(t.data_ptr() for t in Q),
        *(t.data_ptr() for t in out), n, F.L // 2, p, n0, b3w, b3small, strict,
        cuda_lib.stream_ptr(P[0]),
    )
    cuda_lib.LAUNCHES["k3_sw_add"] += 1
    cuda_lib.check(rc, "k3_sw_add")
    return out


def sw_add_mma(F, b3m: int, P, Q):
    """K5c: K3's sum with every multiply's constant products on the int8
    tensor cores (csrc/k5c_sw_add_mma.cu)."""
    n = check_operands(F, *P, *Q)
    if not P[0].is_cuda:
        return rcb_add_mma_plain(F, b3m, P, Q)
    out = tuple(torch.empty_like(P[0]) for _ in range(3))
    if n == 0:
        return out
    p, n0 = _words(F)
    b3w, b3small, strict = kernel_b3(F, b3m)
    rc = cuda_lib.lib().k5c_sw_add_mma(
        *(t.data_ptr() for t in P), *(t.data_ptr() for t in Q),
        *(t.data_ptr() for t in out), n, F.L // 2, p, n0, b3w, b3small, strict,
        mont_mma.fragments(F, P[0].device).data_ptr(), cuda_lib.stream_ptr(P[0]),
    )
    cuda_lib.LAUNCHES["k5c_sw_add_mma"] += 1
    cuda_lib.check(rc, "k5c_sw_add_mma")
    return out
