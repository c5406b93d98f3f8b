"""The ZKCP protocol layer (port of `contangle_zkcp_tpu/zkcp/`): the
Proof-of-Encryption, the SampleEntries property proof, seller and buyer
actors, the adaptor-signature payment and the chain providers.  The
circom property verifier (`property.py`, which needs `circomx/`) is not
ported yet."""

from . import secp, keccak, rlp, ethereum, wallet, config, cipher_host
from .config import ZkConfig, CircomParams
from .verifiable_encryption import (
    ProofOfProperty,
    VerifiableEncryption,
    ZkVerifiableEncryption,
)
from .zk_encryption import ZkEncryption
from .sample_entries import ZkSampleEntries
from .seller import Seller, SellerConfig, Step1Msg
from .buyer import Buyer, BuyerConfig
from .wallet import LocalWallet
