"""The folding scheme's and the vector IPA's device route on the CPU
(the kernels' twins), held against host oracles, never against a JAX
device MSM:

  * `FoldingScheme(..., device="cpu")` on a PoE-shaped structure with 65
    witness bases clears their cofactor with the device ladder
    (`SWDevice.scalar_mul_bits`, K3's twin): the bases equal the host's
    `C.mul(_H1, P)`;
  * a `VectorIPA` of 512 bases with `use_device_msm=True` commits on the
    lockstep engine (K3's twin): the commitment equals `msm_host`, the
    first opening round's L and R equal their host sums, and the proof
    verifies (its folded base is a 512-point device MSM).

Tens of seconds each on one core, so the file sorts after
test_torch_zk_property.py and starts last.
"""

import random

from contangle_zkcp_tpu_torch.circuits.poe_shape import mini_poe_cs
from contangle_zkcp_tpu_torch.curves import instances as ci
from contangle_zkcp_tpu_torch.groth16 import folding
from contangle_zkcp_tpu_torch.groth16.decider import DeciderTranscript
from contangle_zkcp_tpu_torch.groth16.ipa_vec import VectorIPA
from contangle_zkcp_tpu_torch.ops.msm import msm_host
from tests.torch_port_util import one_torch_thread  # noqa: F401

C = ci.BLS12_381_G1
P = folding._R


def test_fold_bases_cleared_on_the_device_route():
    cs = mini_poe_cs(61, 5)
    nw = cs.num_variables - cs.num_instance
    assert nw == folding.HOST_CLEAR_MAX + 1 and cs.num_constraints <= folding.HOST_CLEAR_MAX
    scheme = folding.FoldingScheme(cs, device="cpu")
    raw = folding._hash_points_raw(b"contangle-fold-w", nw)
    assert scheme.bases_w == [C.mul(folding._H1, pt) for pt in raw]
    inst, wit = scheme.instance_from_cs(cs)
    assert scheme.check(inst, wit)


def test_vector_ipa_512_on_the_device_msm():
    n = 512
    rng = random.Random(3)
    step = C.mul(rng.randrange(1, 1 << 64), C.generator)
    bases, acc = [], None
    for _ in range(n):
        acc = C.add(acc, step)
        bases.append(acc)
    ipa = VectorIPA(bases, device="cpu")
    assert ipa._msm is not None
    vec = [rng.randrange(P) for _ in range(n)]
    b = [rng.randrange(P) for _ in range(n)]
    comm = ipa.commit(vec)
    assert comm == msm_host(C, bases, vec)
    proof = ipa.open(vec, b, DeciderTranscript(b"dev"))
    h = n // 2
    vL = sum(x * y for x, y in zip(vec[:h], b[h:])) % P
    vR = sum(x * y for x, y in zip(vec[h:], b[:h])) % P
    L, R = proof.rounds[0]
    assert L == C.add(msm_host(C, bases[h:], vec[:h]), C.mul(vL, ipa.U))
    assert R == C.add(msm_host(C, bases[:h], vec[h:]), C.mul(vR, ipa.U))
    v = sum(x * y for x, y in zip(vec, b)) % P
    assert ipa.verify(comm, b, v, proof, DeciderTranscript(b"dev"))
