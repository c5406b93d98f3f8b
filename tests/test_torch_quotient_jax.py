"""The port's device quotient (plonkish/quotient_device.py, kernel K1's
twin on the CPU) against the JAX package's host quotient loop
(`PlonkSystem._quotient_host`) on the ElGamal circuit at n = 128, seed
301 as in tests/test_quotient_device.py: the same t evaluations.

One test in this file, so that the suite's scheduler (pytest-xdist
--dist loadfile, files with more tests first) starts it after every
other file: the reference's setup takes about a minute on the CPU.
"""

import random

from contangle_zkcp_tpu.plonkish import prover as jprover
from contangle_zkcp_tpu_torch.plonkish.prover import P, PlonkSystem, _coeffs_from_evals
from tests.test_torch_plonkish import JAX_MODS, PORT_MODS, elgamal
from tests.torch_port_util import one_torch_thread  # noqa: F401


def test_quotient_device_equals_reference_host_loop():
    meta, asg, inst = elgamal(PORT_MODS, 301)
    jmeta, jasg, _ = elgamal(JAX_MODS, 301)
    ours = PlonkSystem(meta, 128, asg, device="cpu")
    theirs = jprover.PlonkSystem(jmeta, 128, jasg)
    rng = random.Random(7)
    n, dev = ours.n, ours.device
    advice = [ours._blind(_coeffs_from_evals(list(c), dev), rng) for c in asg.advice]
    inst_polys = [_coeffs_from_evals(list(c) + [0] * (n - len(c)), dev) for c in inst]
    z = ours._blind(_coeffs_from_evals([1] * n, dev), rng)
    theta, beta, gamma, alpha = (rng.randrange(1, P) for _ in range(4))
    args = (advice, inst_polys, z, [], theta, beta, gamma, alpha)
    want = theirs._quotient_host(*args)
    assert ours._quotient_device(*args) == want and any(want)
