"""The port's batched Jubjub device curve (curves/edwards.py EdwardsDevice)
against the host EdwardsCurve and the JAX package's EdwardsDevice (limb
for limb on its add and double), on the kernels' twins."""

import functools
import random

import numpy as np
import pytest
import torch

from contangle_zkcp_tpu.curves.edwards import EdwardsDevice as JEdwardsDevice
from contangle_zkcp_tpu.fields import instances as jfi
from contangle_zkcp_tpu_torch.curves import instances as ci
from contangle_zkcp_tpu_torch.curves.edwards import EdwardsDevice
from contangle_zkcp_tpu_torch.fields import instances as tfi
from tests.torch_port_util import one_torch_thread  # noqa: F401

J = ci.JUBJUB


@functools.lru_cache(maxsize=None)
def devices():
    return EdwardsDevice(tfi.jubjub_fq(), J, device="cpu"), JEdwardsDevice(jfi.jubjub_fq(), J)


def points(n, seed):
    rng = random.Random(seed)
    return [J.mul(rng.randrange(1, J.order), J.generator) for _ in range(n)]


@pytest.mark.parametrize("op", ["add", "double"])
def test_add_double_equal_host_and_reference_limbs(op):
    dev, jdev = devices()
    pts = points(4, 11) + [(0, 1)]  # the identity too
    other = pts[1:] + pts[:1]
    if op == "add":
        got = dev.add(dev.encode_points(pts), dev.encode_points(other))
        ref = jdev.add(jdev.encode_points(pts), jdev.encode_points(other))
        want = [J.add(a, b) for a, b in zip(pts, other)]
    else:
        got = dev.double(dev.encode_points(pts))
        ref = jdev.double(jdev.encode_points(pts))
        want = [J.add(a, a) for a in pts]
    for k in ("x", "y", "z", "t"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]).astype(np.int32), err_msg=k)
    assert dev.decode_points(got) == want
    assert all(J.is_on_curve(p) for p in dev.decode_points(got))


def test_scalar_mul_and_to_affine_equal_host():
    dev, _ = devices()
    rng = random.Random(12)
    ks = [rng.randrange(1, J.order) for _ in range(2)] + [0, 1, 2, J.order - 1]
    G = dev.encode_points([J.generator] * len(ks))
    got = dev.scalar_mul_ints(G, ks)
    assert dev.decode_points(got) == [J.mul(k, J.generator) for k in ks]
    x, y = dev.to_affine(got)
    F = dev.F
    assert list(zip(F.decode(x), F.decode(y))) == [J.mul(k, J.generator) for k in ks]


def test_select_and_identity():
    dev, _ = devices()
    P = dev.encode_points(points(3, 13))
    mixed = dev.select(torch.tensor([True, False, True]), P, dev.identity((3,)))
    assert dev.decode_points(mixed) == [points(3, 13)[0], (0, 1), points(3, 13)[2]]
