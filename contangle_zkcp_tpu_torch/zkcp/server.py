"""Seller HTTP API (mirror of nulltea/contangle-zkcp:server/src/lib.rs).

Same 4 routes and JSON schemas as the Rocket server:
  GET  /info            -> {"price": f64}
  GET  /step0           -> {"ciphertext": [u8], "proof_of_encryption": [u8],
                            "proofs_of_property": [...]}
  GET  /step1/<address> -> {"ciphertext": [u8], "proof_of_encryption": [u8],
                            "data_pk": hex, "address": hex}
  POST /step3           -> body {"pub_key": hex, "enc_sig": hex} -> tx hash hex

Built on asyncio's HTTP-over-streams (stdlib only), bridging to the seller
actor via its inbox queue.
"""

from __future__ import annotations

import asyncio
import json

from . import secp
from .seller import Seller


def _response(status: int, body: bytes, ctype: str = "application/json") -> bytes:
    reason = {200: "OK", 400: "Bad Request", 500: "Internal Server Error", 404: "Not Found"}
    head = (
        f"HTTP/1.1 {status} {reason.get(status, 'Error')}\r\n"
        f"Content-Type: {ctype}\r\n"
        f"Content-Length: {len(body)}\r\n"
        "Connection: close\r\n\r\n"
    )
    return head.encode() + body


class SellerServer:
    def __init__(self, seller: Seller, price: float, host: str = "127.0.0.1", port: int = 8000):
        self.seller = seller
        self.price = price
        self.host = host
        self.port = port
        self._server = None

    async def handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            request_line = await reader.readline()
            parts = request_line.decode().split()
            if len(parts) < 2:
                writer.close()
                return
            method, path = parts[0], parts[1]
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"", b"\n"):
                    break
                k, _, v = line.decode().partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            if "content-length" in headers:
                body = await reader.readexactly(int(headers["content-length"]))
            resp = await self.route(method, path, body)
        except Exception as e:  # noqa: BLE001
            resp = _response(500, json.dumps(str(e)).encode())
        try:
            writer.write(resp)
            await writer.drain()
        finally:
            writer.close()

    async def route(self, method: str, path: str, body: bytes) -> bytes:
        if method == "GET" and path == "/info":
            return _response(200, json.dumps({"price": self.price}).encode())
        if method == "GET" and path == "/step0":
            try:
                ve = await self.seller.call("step0")
            except Exception as e:  # noqa: BLE001
                return _response(500, json.dumps(str(e)).encode())
            return _response(200, json.dumps(ve.to_json()).encode())
        if method == "GET" and path.startswith("/step1/"):
            addr_hex = path[len("/step1/") :]
            try:
                address = bytes.fromhex(addr_hex.removeprefix("0x"))
                assert len(address) == 20
            except Exception:
                return _response(400, json.dumps("bad address").encode())
            try:
                msg = await self.seller.call("step1", address)
            except Exception as e:  # noqa: BLE001
                return _response(500, json.dumps(str(e)).encode())
            return _response(
                200,
                json.dumps(
                    {
                        "ciphertext": list(msg.ciphertext),
                        "proof_of_encryption": list(msg.proof_of_encryption),
                        "data_pk": secp.point_to_bytes(msg.data_pk).hex(),
                        "address": msg.seller_address.hex(),
                    }
                ).encode(),
            )
        if method == "POST" and path == "/step3":
            try:
                req = json.loads(body)
                pub_key = secp.point_from_bytes(bytes.fromhex(req["pub_key"]))
                enc_sig = secp.EncryptedSignature.from_hex(req["enc_sig"])
            except Exception as e:  # noqa: BLE001
                return _response(400, json.dumps(f"bad request: {e}").encode())
            try:
                tx_hash = await self.seller.call("step3", (pub_key, enc_sig))
            except Exception as e:  # noqa: BLE001
                return _response(500, json.dumps(str(e)).encode())
            return _response(200, tx_hash.hex().encode(), ctype="text/plain")
        return _response(404, b'"not found"')

    async def start(self):
        self._server = await asyncio.start_server(self.handle, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def serve_forever(self):
        await self.start()
        async with self._server:
            await self._server.serve_forever()

    def close(self):
        if self._server:
            self._server.close()
