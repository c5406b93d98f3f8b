"""zkcp CLI — setup | sell | buy | compile (port of
`contangle_zkcp_tpu/zkcp/cli.py`, a mirror of nulltea/contangle-zkcp:cmd).

Usage:
  python -m contangle_zkcp_tpu_torch.zkcp.cli setup   --keystore-dir DIR --password PW
  python -m contangle_zkcp_tpu_torch.zkcp.cli compile --cache-dir DIR [--limit N] [--backend groth16|mock]
  python -m contangle_zkcp_tpu_torch.zkcp.cli sell    --cache-dir DIR --data FILE --price P
                                                     [--rpc URL | --mock-chain] [--port PORT]
  python -m contangle_zkcp_tpu_torch.zkcp.cli buy     --cache-dir DIR --seller URL
                                                     [--rpc URL | --mock-chain] --out FILE

Proofs run on the card (`--device cuda`, the default); `ZKCP_MXU=1` selects
the tensor-core kernels K5a-K5c, as in the reference.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from pathlib import Path

from .buyer import Buyer, BuyerConfig
from .cipher_host import LocalHost
from .client import SellerClient
from .config import ZK_CONFIG_FILE, CircomParams, ZkConfig
from .ethereum import Ethereum, MockChain
from .sample_entries import ZkSampleEntries
from .seller import Seller, SellerConfig
from .server import SellerServer
from .wallet import LocalWallet, write_keystore


def _load_zk_config(cache_dir: str) -> ZkConfig:
    path = Path(cache_dir) / ZK_CONFIG_FILE
    if not path.exists():
        print(f"error: {path} not found — run `compile` first", file=sys.stderr)
        sys.exit(1)
    return ZkConfig.load(path)


def _chain(args):
    if getattr(args, "mock_chain", False):
        return MockChain(state_path=str(Path(args.cache_dir) / "mockchain.json"))
    return Ethereum(args.rpc)


def cmd_setup(args):
    wallet = LocalWallet.new()
    path = write_keystore(
        wallet.sec_key(), args.keystore_dir, "keystore.json", args.password.encode()
    )
    print(f"keystore written to {path}")
    print(f"address: 0x{wallet.address().hex()}")


def cmd_compile(args):
    cache = Path(args.cache_dir)
    cache.mkdir(parents=True, exist_ok=True)
    cfg = ZkConfig(
        prop_verifier_dir=str(cache / "prop_verifier"),
        data_encryption_dir=str(cache / "data_encryption"),
        data_encryption_limit=args.limit,
        key_encryption_dir=str(cache / "key_encryption"),
        circom_params=CircomParams(),
        backend=args.backend,
    )
    cfg.save(cache / ZK_CONFIG_FILE)
    from ..circuits import elgamal
    from ..curves import instances as ci
    from .verifiable_encryption import ZkVerifiableEncryption

    print(f"compiling data-encryption circuit (n={args.limit}) ...")
    ve = ZkVerifiableEncryption(
        cfg.data_encryption_dir,
        ZkSampleEntries(cfg.prop_verifier_dir, args.limit, backend=cfg.backend, device=args.device),
        elgamal.ElGamalParams(curve=ci.JUBJUB, n=args.limit),
        backend=cfg.backend,
        device=args.device,
    )
    ve.compile()
    print("compiling key-encryption circuit (n=1) ...")
    from .zk_encryption import ZkEncryption

    ZkEncryption(cfg.key_encryption_dir, backend=cfg.backend, device=args.device).compile()
    print(f"artifacts written under {cache}")


def cmd_sell(args):
    cfg = _load_zk_config(args.cache_dir)
    chain = _chain(args)
    wallet = (
        LocalWallet.from_keystore(args.keystore, args.password.encode())
        if args.keystore
        else LocalWallet.from_hex(args.sk)
        if args.sk
        else LocalWallet.new()
    )
    host = LocalHost(Path(args.cache_dir) / "hosted")
    verifier = ZkSampleEntries(
        cfg.prop_verifier_dir, cfg.data_encryption_limit, backend=cfg.backend, device=args.device
    )
    seller = Seller(
        SellerConfig(price=args.price, cache_dir=args.cache_dir, zk=cfg),
        chain,
        host,
        verifier,
        wallet,
        device=args.device,
    )
    if not host.is_hosted():
        data = Path(args.data).read_bytes()
        print(f"encrypting {len(data)} bytes + proving ...")
        seller.step0_setup(data)
        print("hosted verifiable encryption")

    async def main():
        server = SellerServer(seller, args.price, port=args.port)
        actor = asyncio.create_task(seller.run())
        print(f"seller listening on :{args.port}")
        await server.serve_forever()
        await actor

    asyncio.run(main())


def cmd_buy(args):
    cfg = _load_zk_config(args.cache_dir)
    chain = _chain(args)
    wallet = (
        LocalWallet.from_keystore(args.keystore, args.password.encode())
        if args.keystore
        else LocalWallet.from_hex(args.sk)
        if args.sk
        else LocalWallet.new()
    )
    client = SellerClient(args.seller)
    price = client.price()
    print(f"seller price: {price}")
    verifier = ZkSampleEntries.new_verifier(
        cfg.prop_verifier_dir, cfg.data_encryption_limit, backend=cfg.backend, device=args.device
    )
    buyer = Buyer(BuyerConfig(zk=cfg), chain, verifier, wallet, device=args.device)

    ve = client.download()
    print("verifying proof of encryption + property ...")
    if not buyer.step0_verify(ve):
        print("INVALID verifiable encryption", file=sys.stderr)
        sys.exit(1)
    step1 = client.step1(chain.address_from_pk(wallet.pub_key()))
    enc_sig = buyer.step2(
        step1.ciphertext,
        step1.proof_of_encryption,
        step1.data_pk,
        step1.seller_address,
        price,
    )
    tx_hash = client.step3(wallet.pub_key(), enc_sig)
    print(f"payment broadcast: 0x{tx_hash.hex()}")
    data = asyncio.run(buyer.step4(tx_hash, ve.ciphertext))
    Path(args.out).write_bytes(data)
    print(f"decrypted {len(data)} bytes -> {args.out}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="zkcp")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("setup")
    s.add_argument("--keystore-dir", default="./keys")
    s.add_argument("--password", default="")
    s.set_defaults(fn=cmd_setup)

    c = sub.add_parser("compile")
    c.add_argument("--cache-dir", default="./zkcp-cache")
    # the reference defaults to 100, but its own ZkSampleEntries asserts a
    # power-of-two block count (lib/src/zk/sample_entries.rs:34) — 128 is
    # the nearest usable default.
    c.add_argument("--limit", type=int, default=128)
    c.add_argument("--backend", default="groth16", choices=["groth16", "mock"])
    c.add_argument("--device", default="cuda", help="torch device of the prover (default cuda)")
    c.set_defaults(fn=cmd_compile)

    for name, fn in (("sell", cmd_sell), ("buy", cmd_buy)):
        p = sub.add_parser(name)
        p.add_argument("--cache-dir", default="./zkcp-cache")
        p.add_argument("--rpc", default="http://127.0.0.1:8545")
        p.add_argument("--mock-chain", action="store_true")
        p.add_argument("--keystore")
        p.add_argument("--password", default="")
        p.add_argument("--sk")
        p.add_argument("--device", default="cuda", help="torch device of the prover (default cuda)")
        if name == "sell":
            p.add_argument("--data", required=True)
            p.add_argument("--price", type=float, default=0.1)
            p.add_argument("--port", type=int, default=8000)
        else:
            p.add_argument("--seller", default="http://127.0.0.1:8000")
            p.add_argument("--out", default="./decrypted.bin")
        p.set_defaults(fn=fn)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
