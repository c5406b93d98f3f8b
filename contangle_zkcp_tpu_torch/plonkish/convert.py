"""Carry PLONKish keys and proofs across between the JAX package and this one.

The reference's `PlonkVK`, `PlonkPK`, `PlonkProof` and `IpaProof` hold
only host values (ints, affine points as int pairs or None, lists and
dicts of them), so the port's dataclasses take them field for field.
`from_reference` reads any object with the reference's attributes (it
needs no import of the JAX package); `fields` gives an object's values as
plain nested lists, tuples and dicts, for comparing two keys or proofs;
`to_reference` builds the reference's objects from the classes the
caller passes, so that its verifier can check a proof of this package.
"""

from __future__ import annotations

from .ipa import IpaProof
from .prover import PlonkPK, PlonkProof, PlonkVK

_PROOF_FIELDS = ("advice_comms", "lookup_perm_comms", "z_comm", "lookup_z_comms",
                 "t_comms", "evals", "open_x", "open_wx", "open_wix")


def _plain(v):
    """Host values with points as int tuples, ints as Python ints."""
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, int):
        return int(v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    if isinstance(v, list):
        return [_plain(x) for x in v]
    if hasattr(v, "rounds") and hasattr(v, "a_final"):
        return {"rounds": _plain(v.rounds), "a_final": int(v.a_final)}
    if hasattr(v, "fixed_polys"):
        return {"vk": _plain(v.vk), "fixed_polys": _plain(v.fixed_polys),
                "sigma_polys": _plain(v.sigma_polys), "sigma_evals": _plain(v.sigma_evals)}
    if hasattr(v, "fixed_comms"):
        return {"n": int(v.n), "ext": int(v.ext), "fixed_comms": _plain(v.fixed_comms),
                "sigma_comms": _plain(v.sigma_comms), "perm_cols": _plain(v.perm_cols),
                "deltas": _plain(v.deltas)}
    if hasattr(v, "advice_comms"):
        return {k: _plain(getattr(v, k)) for k in _PROOF_FIELDS}
    return int(v)


def fields(obj):
    """A key, proof or IpaProof of either package as plain nested values."""
    return _plain(obj)


def _ipa(d):
    return None if d is None else IpaProof(rounds=[tuple(r) for r in d["rounds"]],
                                           a_final=d["a_final"])


def _vk(d):
    return PlonkVK(n=d["n"], ext=d["ext"], fixed_comms=d["fixed_comms"],
                   sigma_comms=d["sigma_comms"], perm_cols=[tuple(c) for c in d["perm_cols"]],
                   deltas=d["deltas"])


def from_reference(obj):
    """The reference's PlonkProof, PlonkPK, PlonkVK or IpaProof -> this
    package's."""
    d = fields(obj)
    if hasattr(obj, "advice_comms"):
        return PlonkProof(**{k: d[k] for k in _PROOF_FIELDS[:6]},
                          open_x=_ipa(d["open_x"]), open_wx=_ipa(d["open_wx"]),
                          open_wix=_ipa(d["open_wix"]))
    if hasattr(obj, "fixed_polys"):
        return PlonkPK(vk=_vk(d["vk"]), fixed_polys=d["fixed_polys"],
                       sigma_polys=d["sigma_polys"], sigma_evals=d["sigma_evals"])
    if hasattr(obj, "fixed_comms"):
        return _vk(d)
    return _ipa(d)


def to_reference(obj, classes):
    """This package's PlonkProof, PlonkPK, PlonkVK or IpaProof -> the
    reference's; `classes` maps "PlonkProof", "PlonkPK", "PlonkVK" and
    "IpaProof" to the reference's classes."""
    d = fields(obj)

    def ipa(x):
        return None if x is None else classes["IpaProof"](
            rounds=[tuple(r) for r in x["rounds"]], a_final=x["a_final"])

    def vk(x):
        return classes["PlonkVK"](**{**x, "perm_cols": [tuple(c) for c in x["perm_cols"]]})

    if isinstance(obj, PlonkProof):
        return classes["PlonkProof"](**{k: d[k] for k in _PROOF_FIELDS[:6]},
                                     open_x=ipa(d["open_x"]), open_wx=ipa(d["open_wx"]),
                                     open_wix=ipa(d["open_wix"]))
    if isinstance(obj, PlonkPK):
        return classes["PlonkPK"](vk=vk(d["vk"]), fixed_polys=d["fixed_polys"],
                                  sigma_polys=d["sigma_polys"], sigma_evals=d["sigma_evals"])
    if isinstance(obj, PlonkVK):
        return vk(d)
    return ipa(d)
