"""contangle_zkcp_tpu_torch — the PyTorch/CUDA port of contangle_zkcp_tpu.

The JAX package `contangle_zkcp_tpu` is the reference; this package keeps
its sub-package layout so a reader finds each counterpart, imports torch
and never JAX, and runs its device math on an NVIDIA Hopper card through
hand-written CUDA kernels (csrc/):

  K1  csrc/k1_mont_mul.cu        Montgomery multiply          (ops/mont.py)
  K2  csrc/k2_butterfly.cu       fused NTT butterfly          (ops/mont.py)
      csrc/k2_ntt.cu             several NTT stages a launch  (ops/mont.py ntt_pass)
  K3  csrc/k3_sw_add.cu          complete G1 point add        (ops/curve_add.py)
  K4  csrc/k1_mont_mul.cu        row-major multiply entry     (ops/field_mul.py)
  K5a csrc/k5a_mont_mul_mma.cu   K1 on the int8 tensor cores  (ops/mont_mma.py)
  K5b csrc/k5b_butterfly_mma.cu  K2 on the int8 tensor cores  (ops/mont_mma.py)
      csrc/k5b_ntt_mma.cu        k2_ntt.cu's passes, the same (ops/mont_mma.py ntt_pass_mma)
  K5c csrc/k5c_sw_add_mma.cu     K3 on the int8 tensor cores  (ops/curve_add.py)

ZKCP_MXU=1 selects K5a-K5c in place of K1-K3, as it selects the
matrix-unit kernels in the JAX package.

Each kernel has a plain torch twin with the same signature; a wrapper
takes the twin only for CPU tensors.  Entry points take a `device`
argument that defaults to "cuda"; the tests pass device="cpu".

Ported so far: the whole ZKCP sale over BLS12-381 — compile, the seller's
Proof of Encryption (zkcp/zk_encryption.py) and SampleEntries proof, the
buyer's verification with the device Poseidon Merkle root, the
adaptor-signature payment on a chain, the HTTP server, client and CLI
(zkcp/) — except the circom property verifier.
"""

__version__ = "0.1.0"
