"""The ZKCP protocol layer (port of `contangle_zkcp_tpu/zkcp/`): the
Proof-of-Encryption, the SampleEntries property proof, the circom Proof
of Property (`property.py`, over `circomx/`), seller and buyer actors,
the adaptor-signature payment and the chain providers."""

from . import secp, keccak, rlp, ethereum, wallet, config, cipher_host
from .config import ZkConfig, CircomParams
from .verifiable_encryption import (
    ProofOfProperty,
    VerifiableEncryption,
    ZkVerifiableEncryption,
)
from .zk_encryption import ZkEncryption
from .sample_entries import ZkSampleEntries
from .property import ZkPropertyVerifier
from .seller import Seller, SellerConfig, Step1Msg
from .buyer import Buyer, BuyerConfig
from .wallet import LocalWallet
