"""The port's protocol layer against the JAX package on the CPU: the
payment crypto byte for byte, the key derivation, the whole sale with the
mock snark backend over HTTP and MockChain (as tests/test_protocol_e2e.py
runs it), and the wire formats across the two packages, each side a
seller or a buyer of the other."""

import asyncio
import random

import pytest

from contangle_zkcp_tpu import zkcp as jzkcp
from contangle_zkcp_tpu.circuits import elgamal as jelgamal
from contangle_zkcp_tpu.curves import instances as jci
from contangle_zkcp_tpu.zkcp import cipher_host as jhost
from contangle_zkcp_tpu.zkcp import client as jclient
from contangle_zkcp_tpu.zkcp import ethereum as jeth
from contangle_zkcp_tpu.zkcp import keccak as jkeccak
from contangle_zkcp_tpu.zkcp import rlp as jrlp
from contangle_zkcp_tpu.zkcp import secp as jsecp
from contangle_zkcp_tpu.zkcp import server as jserver
from contangle_zkcp_tpu.zkcp import wallet as jwallet
from contangle_zkcp_tpu.zkcp import zk_encryption as jzk
from contangle_zkcp_tpu_torch import zkcp as tzkcp
from contangle_zkcp_tpu_torch.circuits import elgamal as telgamal
from contangle_zkcp_tpu_torch.curves import instances as tci
from contangle_zkcp_tpu_torch.zkcp import cipher_host as thost
from contangle_zkcp_tpu_torch.zkcp import client as tclient
from contangle_zkcp_tpu_torch.zkcp import ethereum as teth
from contangle_zkcp_tpu_torch.zkcp import keccak as tkeccak
from contangle_zkcp_tpu_torch.zkcp import rlp as trlp
from contangle_zkcp_tpu_torch.zkcp import secp as tsecp
from contangle_zkcp_tpu_torch.zkcp import server as tserver
from contangle_zkcp_tpu_torch.zkcp import wallet as twallet
from contangle_zkcp_tpu_torch.zkcp import zk_encryption as tzk
from tests.torch_port_util import one_torch_thread  # noqa: F401

N = 16
PRICE = 0.25

# One side of the sale: the package's modules, and the keyword that puts
# its device work on the CPU (the JAX package has no such argument).
SIDES = {
    "jax": dict(zkcp=jzkcp, elgamal=jelgamal, ci=jci, host=jhost, client=jclient, eth=jeth,
                server=jserver, zk=jzk, secp=jsecp, dev={}),
    "torch": dict(zkcp=tzkcp, elgamal=telgamal, ci=tci, host=thost, client=tclient, eth=teth,
                  server=tserver, zk=tzk, secp=tsecp, dev={"device": "cpu"}),
}


def test_keccak_and_rlp_vectors():
    for msg in (b"", b"abc", bytes(range(256)) * 3):
        assert tkeccak.keccak256(msg) == jkeccak.keccak256(msg)
    assert (
        tkeccak.keccak256(b"abc").hex()
        == "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    )
    items = [0, 1, 127, 128, 2**64, b"", b"\x01", b"x" * 60, [b"dog", [b"cat", 1024]], b"\xff" * 300]
    for item in items:
        assert trlp.encode(item) == jrlp.encode(item)
    assert trlp.encode([b"cat", b"dog"]).hex() == "c88363617483646f67"


@pytest.mark.parametrize("seed", [51, 52])
def test_secp_sign_verify_recover_equal(seed):
    tsk, tpk = tsecp.keypair_gen(random.Random(seed))
    jsk, jpk = jsecp.keypair_gen(random.Random(seed))
    assert (tsk, tpk) == (jsk, jpk)
    assert tsecp.point_to_bytes(tpk) == jsecp.point_to_bytes(jpk)
    msg = tkeccak.keccak256(b"hello %d" % seed)
    tsig, jsig = tsecp.sign(tsk, msg), jsecp.sign(jsk, msg)
    assert tsig.to_bytes() == jsig.to_bytes()
    assert tsecp.verify(tpk, msg, jsig) and jsecp.verify(jpk, msg, tsig)
    assert not tsecp.verify(tpk, tkeccak.keccak256(b"other"), tsig)
    assert [tsecp.recover_pubkey(msg, tsig, i) for i in (0, 1)] == [
        jsecp.recover_pubkey(msg, jsig, i) for i in (0, 1)
    ]


def test_adaptor_signature_equal_across_packages():
    rng = random.Random(52)
    sk, pk = tsecp.keypair_gen(rng)
    y, Y = tsecp.keypair_gen(rng)
    msg = tkeccak.keccak256(b"payment tx")
    tes, jes = tsecp.encrypted_sign(sk, Y, msg), jsecp.encrypted_sign(sk, Y, msg)
    # deterministic nonce: R, R_hat and s_hat agree; the DLEQ proof draws
    # its own randomness, so each side checks the other's
    assert (tes.R, tes.R_hat, tes.s_hat) == (jes.R, jes.R_hat, jes.s_hat)
    k = tsecp._rfc6979_k(sk, msg, extra=tsecp.point_to_bytes(Y))
    tp = tsecp.dleq_prove(k, Y, tes.R_hat, tes.R, random.Random(7))
    jp = jsecp.dleq_prove(k, Y, jes.R_hat, jes.R, random.Random(7))
    assert (tp.c, tp.z) == (jp.c, jp.z)
    assert tsecp.verify_encrypted_signature(pk, Y, msg, tsecp.EncryptedSignature.from_hex(jes.to_hex()))
    assert jsecp.verify_encrypted_signature(pk, Y, msg, jsecp.EncryptedSignature.from_hex(tes.to_hex()))
    bad = tsecp.EncryptedSignature(tes.R, tes.R_hat, (tes.s_hat + 1) % tsecp.N, tes.proof)
    assert not tsecp.verify_encrypted_signature(pk, Y, msg, bad)
    tsig, jsig = tsecp.decrypt_signature(y, tes), jsecp.decrypt_signature(y, jes)
    assert tsig.to_bytes() == jsig.to_bytes() and tsecp.verify(pk, msg, tsig)
    assert tsecp.recover_decryption_key(Y, tsig, tes) == jsecp.recover_decryption_key(Y, jsig, jes) == y


def test_keystore_roundtrip_and_bip39_golden(tmp_path):
    hexkey = "4c0883a69102937d6231471b5dbb6204fe5129617082792ae468d01a3f362318"
    w = twallet.LocalWallet.from_hex(hexkey)
    assert w.address().hex() == "2c7536e3605d9c16a7a3d7b1898e529396a65c23"
    tpath = twallet.write_keystore(w.sec_key(), tmp_path / "t", "ks.json", b"pw123")
    jpath = jwallet.write_keystore(w.sec_key(), tmp_path / "j", "ks.json", b"pw123")
    assert jwallet.read_keystore(tpath, b"pw123") == twallet.read_keystore(jpath, b"pw123") == w.sec_key()
    with pytest.raises(Exception):
        twallet.read_keystore(tpath, b"wrong")
    phrase = "test test test test test test test test test test test junk"
    sk, pk = twallet.keypair_from_bip39(phrase)
    assert hex(sk) == "0xac0974bec39a17e36ba4a6b4d238ff944bacb478cbed5efcae784d7bf4f2ff80"
    assert (sk, pk) == jwallet.keypair_from_bip39(phrase)
    assert twallet.LocalWallet.from_bip39(phrase).address().hex() == "f39fd6e51aad88f6f4ce6ab8827279cfffb92266"


def test_eip155_tx_bytes_equal():
    rng = random.Random(53)
    w = twallet.LocalWallet.new(rng)
    tchain, jchain = teth.MockChain(), jeth.MockChain()
    to = bytes(range(20))
    ttx, th = tchain.compose_tx(w.address(), to, 1.5)
    jtx, jh = jchain.compose_tx(w.address(), to, 1.5)
    assert th == jh
    sig = tsecp.sign(w.sec_key(), th)
    v = teth.derive_v_by_trial(ttx, sig)
    assert v == jeth.derive_v_by_trial(jtx, sig)
    assert ttx.rlp_signed(v, sig.r, sig.s) == jtx.rlp_signed(v, sig.r, sig.s)
    assert tchain.sent_signed(ttx, sig) == jchain.sent_signed(jtx, sig)
    assert tchain.balances[to] == int(1.5 * 10**18)


@pytest.mark.parametrize("seed", [70, 71])
def test_keygen_derive_equal(seed):
    tz = tzk.ZkEncryption("unused", backend="mock", device="cpu")
    jz = jzk.ZkEncryption("unused", backend="mock")
    assert tz.keygen_derive(random.Random(seed)) == jz.keygen_derive(random.Random(seed))


def _compile(side, tmp_path):
    s = SIDES[side]
    cfg = s["zkcp"].ZkConfig(
        prop_verifier_dir=str(tmp_path / "prop"),
        data_encryption_dir=str(tmp_path / "data_enc"),
        data_encryption_limit=N,
        key_encryption_dir=str(tmp_path / "key_enc"),
        circom_params=s["zkcp"].CircomParams(),
        backend="mock",
    )
    s["zkcp"].ZkVerifiableEncryption(
        cfg.data_encryption_dir,
        s["zkcp"].ZkSampleEntries(cfg.prop_verifier_dir, N, backend="mock", **s["dev"]),
        s["elgamal"].ElGamalParams(curve=s["ci"].JUBJUB, n=N),
        backend="mock",
        **s["dev"],
    ).compile()
    s["zk"].ZkEncryption(cfg.key_encryption_dir, backend="mock", **s["dev"]).compile()
    return cfg


def _sale(seller_side, buyer_side, tmp_path, data):
    """compile -> seller step 0 -> HTTP server; the buyer downloads,
    verifies, pays by adaptor signature, recovers the key and decrypts.
    The two sides share one MockChain through its state file, as the
    CLI's --mock-chain mode does."""
    S, B = SIDES[seller_side], SIDES[buyer_side]
    scfg = _compile(seller_side, tmp_path)
    bcfg = B["zkcp"].ZkConfig.from_json(scfg.to_json())
    state = str(tmp_path / "mockchain.json")
    schain = S["eth"].MockChain(state_path=state)
    bchain = B["eth"].MockChain(state_path=state)
    swallet = S["zkcp"].LocalWallet.new(random.Random(63))
    bwallet = B["zkcp"].LocalWallet.new(random.Random(64))
    seller = S["zkcp"].Seller(
        S["zkcp"].SellerConfig(price=PRICE, cache_dir=str(tmp_path / "cache"), zk=scfg),
        schain,
        S["host"].LocalHost(tmp_path / "hosted"),
        S["zkcp"].ZkSampleEntries(scfg.prop_verifier_dir, N, backend="mock", **S["dev"]),
        swallet,
        **S["dev"],
    )
    seller.step0_setup(data)
    assert (tmp_path / "cache" / "decryption_key").exists()

    async def scenario():
        server = S["server"].SellerServer(seller, PRICE, port=0)
        await server.start()
        actor = asyncio.create_task(seller.run())

        def buyer_flow():
            client = B["client"].SellerClient(f"http://127.0.0.1:{server.port}")
            assert client.price() == PRICE
            buyer = B["zkcp"].Buyer(
                B["zkcp"].BuyerConfig(zk=bcfg),
                bchain,
                B["zkcp"].ZkSampleEntries.new_verifier(bcfg.prop_verifier_dir, N, backend="mock", **B["dev"]),
                bwallet,
                **B["dev"],
            )
            ve = client.download()
            assert buyer.step0_verify(ve)
            step1 = client.step1(bchain.address_from_pk(bwallet.pub_key()))
            enc_sig = buyer.step2(
                step1.ciphertext, step1.proof_of_encryption, step1.data_pk, step1.seller_address, PRICE
            )
            tx_hash = client.step3(bwallet.pub_key(), enc_sig)
            return buyer, ve, tx_hash

        buyer, ve, tx_hash = await asyncio.get_running_loop().run_in_executor(None, buyer_flow)
        plaintext = await buyer.step4(tx_hash, ve.ciphertext)
        server.close()
        actor.cancel()
        return plaintext, ve, tx_hash

    plaintext, ve, tx_hash = asyncio.run(scenario())
    assert plaintext == data
    seller_addr = schain.address_from_pk(swallet.pub_key())
    bchain._load()
    assert bchain.balances.get(seller_addr) == int(PRICE * 10**18)
    return ve, tx_hash, bchain, bwallet.address(), seller_addr


@pytest.mark.parametrize(
    "seller_side,buyer_side",
    [("torch", "torch"), ("torch", "jax"), ("jax", "torch")],
    ids=["port-sells-to-port", "port-sells-to-jax", "jax-sells-to-port"],
)
def test_sale_end_to_end(seller_side, buyer_side, tmp_path):
    """The whole sale at N = 16; across packages every message crosses
    the wire: the step-0 VerifiableEncryption JSON, the Step1Msg, the
    step-3 adaptor signature and transaction hash, and the chain file."""
    data = b"secret dataset!!"
    ve, tx_hash, chain, buyer_addr, seller_addr = _sale(seller_side, buyer_side, tmp_path, data)
    # the hosted ciphertext parses on both sides to the same blocks
    for side in ("jax", "torch"):
        s = SIDES[side]
        params = s["elgamal"].ElGamalParams(curve=s["ci"].JUBJUB, n=N)
        c1, c2 = s["zk"].ciphertext_from_bytes(ve.ciphertext, params)
        assert len(c2) == N
    # the broadcast transaction: both packages rebuild it from the chain's
    # signature to the bytes whose hash the seller returned
    sig = chain.get_signature(tx_hash)
    for eth, keccak in ((teth, tkeccak), (jeth, jkeccak)):
        tx, _ = eth.MockChain().compose_tx(buyer_addr, seller_addr, PRICE)
        raw = tx.rlp_signed(eth.derive_v_by_trial(tx, sig), sig.r, sig.s)
        assert keccak.keccak256(raw) == tx_hash


def test_sale_with_a_data_key_whose_top_byte_is_zero(tmp_path, monkeypatch):
    """The key decryption drops a data key's trailing zero bytes (the
    shared chunks_to_bytes); the port's buyer gives the key back its width,
    so a sale whose data key is below 2^248 still decrypts."""
    keygen = tzk.ZkEncryption.keygen
    made = []

    def small_keygen(self, rng=None):
        while True:
            sk, pk = keygen(self, rng)
            if sk >> 248 == 0:
                made.append(sk)
                return sk, pk

    monkeypatch.setattr(tzk.ZkEncryption, "keygen", small_keygen)
    data = b"secret dataset!!"
    _sale("torch", "torch", tmp_path, data)
    assert (tmp_path / "cache" / "decryption_key").read_bytes()[-1] == 0 and made


def test_step3_rejects_bad_adaptor_sig(tmp_path):
    cfg = _compile("torch", tmp_path)
    chain = teth.MockChain()
    swallet = tzkcp.LocalWallet.new(random.Random(65))
    bwallet = tzkcp.LocalWallet.new(random.Random(66))
    seller = tzkcp.Seller(
        tzkcp.SellerConfig(price=PRICE, cache_dir=str(tmp_path / "cache"), zk=cfg),
        chain,
        thost.EphemeralHost(),
        tzkcp.ZkSampleEntries(cfg.prop_verifier_dir, N, backend="mock", device="cpu"),
        swallet,
        device="cpu",
    )
    seller.step0_setup(b"data")
    step1 = seller.handle_step1(chain.address_from_pk(bwallet.pub_key()))
    _, wrong_hash = chain.compose_tx(
        chain.address_from_pk(bwallet.pub_key()), chain.address_from_pk(swallet.pub_key()), PRICE * 2
    )
    bad_sig = tsecp.encrypted_sign(bwallet.sec_key(), step1.data_pk, wrong_hash)
    with pytest.raises(Exception, match="invalid adaptor signature"):
        seller.handle_step3(bwallet.pub_key(), bad_sig)
