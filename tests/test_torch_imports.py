"""The port stands alone: no module of contangle_zkcp_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package; its entry points default
to the card."""

import ast
import inspect
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "contangle_zkcp_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_prove.py",
                                       ROOT / "scripts" / "parallel_ranks.py"]
FORBIDDEN = ("jax", "jaxlib", "contangle_zkcp_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_port_covers_the_slice():
    for rel in (
        "fields/fp.py",
        "ops/ntt.py",
        "ops/msm.py",
        "ops/fixed_base.py",
        "curves/weierstrass.py",
        "groth16/groth16.py",
        "groth16/convert.py",
        "zkcp/zk_encryption.py",
        "csrc/k1_mont_mul.cu",
        "csrc/k2_butterfly.cu",
        "csrc/k3_sw_add.cu",
        # the sale (second slice)
        "ops/mont_mma.py",
        "ops/field_mul.py",
        "ops/merkle.py",
        "circuits/sample_entries_circuit.py",
        "zkcp/keccak.py",
        "zkcp/rlp.py",
        "zkcp/aes.py",
        "zkcp/secp.py",
        "zkcp/wallet.py",
        "zkcp/config.py",
        "zkcp/ethereum.py",
        "zkcp/verifiable_encryption.py",
        "zkcp/sample_entries.py",
        "zkcp/cipher_host.py",
        "zkcp/seller.py",
        "zkcp/buyer.py",
        "zkcp/server.py",
        "zkcp/client.py",
        "zkcp/cli.py",
        "csrc/k5_mma.cuh",
        "csrc/k5a_mont_mul_mma.cu",
        "csrc/k5b_butterfly_mma.cu",
        "csrc/k5c_sw_add_mma.cu",
        # the PLONKish prover (third slice)
        "plonkish/__init__.py",
        "plonkish/circuit.py",
        "plonkish/mock.py",
        "plonkish/transcript.py",
        "plonkish/poseidon_pow5.py",
        "plonkish/pow5_pinned_pasta.json",
        "plonkish/elgamal_circuit.py",
        "plonkish/ecc_chip.py",
        "plonkish/ecc_tables_pallas.json",
        "plonkish/ipa.py",
        "plonkish/quotient_device.py",
        "plonkish/prover.py",
        "plonkish/convert.py",
        # K2 redesigned: several NTT stages a launch
        "csrc/k2_ntt.cu",
        # the proving-scale MSM engines, the Jubjub device curve, the
        # arkworks RNG
        "ops/msm_policy.py",
        "ops/msm_grid.py",
        "ops/msm_balanced.py",
        "ops/msm_tree.py",
        "curves/edwards.py",
        "conformance/__init__.py",
        "conformance/chacha.py",
        "conformance/ark_rng.py",
        # the circom Proof of Property
        "circomx/__init__.py",
        "circomx/r1cs_format.py",
        "circomx/dummy.py",
        "circomx/wasm.py",
        "circomx/witness_calc.py",
        "circomx/wrapper.py",
        "zkcp/property.py",
        # the folding accumulator and its decider, the trapdoor aids,
        # the profiling module
        "groth16/sumcheck.py",
        "groth16/ipa_vec.py",
        "groth16/folding.py",
        "groth16/decider.py",
        "groth16/aggregate.py",
        "utils/profiling.py",
        "circuits/poe_shape.py",
        # parallel/: the sharded MSM, the four-step and sharded NTT, the
        # mesh fold pipeline
        "parallel/__init__.py",
        "parallel/mesh.py",
        "parallel/msm_sharded.py",
        "parallel/ntt_sharded.py",
        "parallel/fold_pipeline.py",
    ):
        assert (PORT / rel).exists(), rel


def test_ntt_runs_batches():
    """The four-step NTT's local transforms: ops/ntt.py's batched entry
    points, as the JAX package's NTT has them."""
    from contangle_zkcp_tpu_torch.ops.ntt import NTT

    assert callable(NTT.forward_batched) and callable(NTT.inverse_batched)


def _entry_points():
    from contangle_zkcp_tpu_torch.curves.edwards import EdwardsDevice
    from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
    from contangle_zkcp_tpu_torch.fields.fp import Fp
    from contangle_zkcp_tpu_torch.groth16 import groth16, convert
    from contangle_zkcp_tpu_torch.groth16.aggregate import batch_verify
    from contangle_zkcp_tpu_torch.groth16.folding import FoldingScheme
    from contangle_zkcp_tpu_torch.groth16.ipa_vec import VectorIPA
    from contangle_zkcp_tpu_torch.ops.ntt import NTT
    from contangle_zkcp_tpu_torch.ops.merkle import build_tree_device
    from contangle_zkcp_tpu_torch.parallel.mesh import make_mesh
    from contangle_zkcp_tpu_torch.plonkish.ipa import IPA
    from contangle_zkcp_tpu_torch.plonkish.prover import PlonkSystem
    from contangle_zkcp_tpu_torch.plonkish.quotient_device import QuotientDevice
    from contangle_zkcp_tpu_torch.zkcp.buyer import Buyer
    from contangle_zkcp_tpu_torch.zkcp.property import ZkPropertyVerifier
    from contangle_zkcp_tpu_torch.zkcp.sample_entries import ZkSampleEntries
    from contangle_zkcp_tpu_torch.zkcp.seller import Seller
    from contangle_zkcp_tpu_torch.zkcp.verifiable_encryption import ZkVerifiableEncryption
    from contangle_zkcp_tpu_torch.zkcp.zk_encryption import ZkEncryption

    return [
        ZkEncryption.__init__,
        ZkEncryption.new_verifier,
        groth16.Groth16.__init__,
        groth16.curve_ctx,
        groth16.QAP.eval_rows_device,
        convert.from_reference,
        NTT.__init__,
        SWDevice.__init__,
        Fp.encode,
        Fp.encode_u64,
        Fp.zeros,
        Fp.one_mont,
        Fp.broadcast_const,
        ZkSampleEntries.__init__,
        ZkSampleEntries.new_verifier,
        ZkVerifiableEncryption.__init__,
        ZkVerifiableEncryption.new_verifier,
        Seller.__init__,
        Buyer.__init__,
        build_tree_device,
        PlonkSystem.__init__,
        IPA.__init__,
        QuotientDevice.__init__,
        EdwardsDevice.__init__,
        ZkPropertyVerifier.__init__,
        FoldingScheme.__init__,
        VectorIPA.__init__,
        batch_verify,
        make_mesh,
    ]


def test_decider_and_trapdoor_aids_are_ported():
    """The decider runs on its scheme's device; the Groth16 trapdoor aids
    exist with the reference's signatures."""
    from contangle_zkcp_tpu_torch.groth16.decider import Decider
    from contangle_zkcp_tpu_torch.groth16.groth16 import Groth16

    assert list(inspect.signature(Decider.__init__).parameters) == ["self", "fs", "use_device_msm"]
    assert inspect.signature(Groth16.setup).parameters["debug_trapdoor"].default is False
    assert callable(Groth16._debug_check_msms)


def test_kernel_list_names_every_source():
    """Every kernel the launch counters know has its source in csrc/."""
    from contangle_zkcp_tpu_torch.ops import cuda_lib

    text = "".join(p.read_text() for p in (PORT / "csrc").glob("*.cu"))
    for name in cuda_lib.KERNELS:
        assert f'extern "C" int {name}(' in text, name


def test_cli_device_defaults_to_cuda():
    from contangle_zkcp_tpu_torch.zkcp import cli

    for argv in (["compile"], ["sell", "--data", "x"], ["buy"]):
        assert cli.parser().parse_args(argv).device == "cuda", argv[0]


@pytest.mark.parametrize("idx", range(29))
def test_entry_points_default_to_cuda(idx):
    fn = _entry_points()[idx]
    assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
