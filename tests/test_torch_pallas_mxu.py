"""The tensor-core kernels' plain torch versions against the Pallas kernels
they replace in the reference's matrix-unit mode (`mxu=True`), run in
interpret mode on the CPU on one 128-lane tile:

  * K5a's twin (ops/mont_mma.py mont_mul_mma_plain) == MontMulLanes.mul_t
    with mxu, Fr and Fq;
  * K5c's twin (ops/curve_add.py rcb_add_mma_plain) == PallasSWAdd.add_t
    with mxu, with identity on either side, P + P and P + (-P) among the
    pairs.

Tracing a Pallas kernel in interpret mode costs XLA:CPU up to a minute
(the point add), so these checks sit in a file of their own, which the
tier-1 run's scheduler starts last.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from contangle_zkcp_tpu.curves import instances as jci
from contangle_zkcp_tpu.curves.weierstrass import SWDevice as JSW
from contangle_zkcp_tpu.fields import instances as jfi
from contangle_zkcp_tpu.ops.pallas_curve import PallasSWAdd
from contangle_zkcp_tpu.ops.pallas_mont import MontMulLanes
from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
from contangle_zkcp_tpu_torch.fields import instances as tfi
from contangle_zkcp_tpu_torch.ops import curve_add, mont_mma
from tests.test_torch_pallas import limbs
from tests.torch_port_util import one_torch_thread, rand_ints  # noqa: F401

T = 128  # one lane tile


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_k5a_twin_matches_pallas_mxu_tile(name):
    jF = getattr(jfi, f"bls12_381_{name}")()
    tF = getattr(tfi, f"bls12_381_{name}")()
    a = np.asarray(jF.encode(rand_ints(jF.p, T - 3, 41)))
    b = np.asarray(jF.encode(rand_ints(jF.p, T - 3, 42)))[::-1].copy()
    eng = MontMulLanes(jF, lane_tile=T, mxu=True)
    want = np.asarray(eng.mul_t(jnp.asarray(a.T), jnp.asarray(b.T), interpret=True)).T
    got = mont_mma.mont_mul_mma_plain(tF, limbs(a), limbs(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_k5c_twin_matches_pallas_mxu_kernel():
    jFq, tFq = jfi.bls12_381_fq(), tfi.bls12_381_fq()
    C = jci.BLS12_381_G1
    jdev, tdev = JSW(jFq, C), SWDevice(tFq, C, device="cpu")
    rng = np.random.default_rng(8)
    base = [C.mul(int(k), C.generator) for k in rng.integers(1, 1 << 20, size=8)]
    i1, i2 = rng.integers(0, 8, size=T), rng.integers(0, 8, size=T)
    left = [base[i] for i in i1]
    right = [base[i] for i in i2]
    for j in range(0, 16):  # P + P
        right[j] = left[j]
    for j in range(16, 32):  # P + (-P)
        right[j] = (left[j][0], (-left[j][1]) % jfi.BLS12_381_P)
    for j in range(32, 48):  # O + Q, P + O
        left[j] = None
    for j in range(48, 64):
        right[j] = None
    jP, jQ = jdev.encode_points(left), jdev.encode_points(right)
    eng = PallasSWAdd(jFq, np.asarray(jdev._b3), lane_tile=T, mxu=True)
    want = eng.add_t(
        tuple(jnp.asarray(np.asarray(jP[k]).T) for k in ("x", "y", "z")),
        tuple(jnp.asarray(np.asarray(jQ[k]).T) for k in ("x", "y", "z")),
        interpret=True,
    )
    tP, tQ = tdev.encode_points(left), tdev.encode_points(right)
    got = curve_add.rcb_add_mma_plain(
        tFq, tdev._b3m, tuple(tP[k] for k in "xyz"), tuple(tQ[k] for k in "xyz")
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).T)
    assert tdev.decode_points(dict(zip("xyz", got))) == [C.add(a, b) for a, b in zip(left, right)]
