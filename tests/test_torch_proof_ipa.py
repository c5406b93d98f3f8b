"""The port's IPA openings against the JAX package's host paths
(use_device_msm=False): at 256 generators through a shared Blake2b
transcript, the port's round MSMs on the CPU's twins; and at 1,024
generators, where the port folds the generators on the device (two
255-bit ladders of K3's twin and one add per round, down to h < 256),
against the reference's host fold.  The same rounds and final scalar.

One test in this file, so that the suite's scheduler (pytest-xdist
--dist loadfile, files with more tests first) starts it after every
other file: the device fold on the twins takes minutes on a CPU.
"""

import random

from contangle_zkcp_tpu.plonkish import ipa as jipa
from contangle_zkcp_tpu.plonkish import transcript as jtr
from contangle_zkcp_tpu_torch.fields import instances as fi
from contangle_zkcp_tpu_torch.plonkish import ipa, transcript
from contangle_zkcp_tpu_torch.plonkish.convert import fields
from tests.torch_port_util import one_torch_thread  # noqa: F401


def test_openings_equal_reference_host_fold():
    rng = random.Random(93)
    for n, shared in ((256, True), (1024, False)):
        coeffs = [rng.randrange(fi.PASTA_P) for _ in range(n - 3)]
        x = rng.randrange(fi.PASTA_P)
        ours = ipa.IPA(n, use_device_msm=True, device="cpu")
        kw = {"transcript": transcript.Blake2bTranscript()} if shared else {}
        jkw = {"transcript": jtr.Blake2bTranscript()} if shared else {}
        got = ours.open(coeffs, x, **kw)
        assert fields(got) == fields(jipa.IPA(n).open(coeffs, x, **jkw)), n
        if not shared:
            v = sum(c * pow(x, i, fi.PASTA_P) for i, c in enumerate(coeffs)) % fi.PASTA_P
            assert ours.verify(ours.commit(coeffs), x, v, got)
