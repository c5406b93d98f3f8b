"""Bit-exactness conformance layer vs the Rust original (contangle-zkcp).

Port of `contangle_zkcp_tpu/conformance/` (host code; the port keeps its
own copy).  Reimplements the deterministic plumbing the Rust original's
tests rely on —
`ark_std::test_rng()` (rand 0.8 StdRng = ChaCha12, fixed seed), arkworks
0.3 `UniformRand` field/scalar sampling, `from_random_bytes` — so the
original's RNG transcripts replay byte-for-byte and golden vectors can
be pinned (tests/conformance/).
"""
