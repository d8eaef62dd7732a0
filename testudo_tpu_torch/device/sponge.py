"""Device-resident Poseidon sponge and Fiat-Shamir transcript.

Counterpart of testudo_tpu/tpu/sponge.py: `_mont_consts`, `_spec_of`,
`permute`, `DeviceSponge`, `fr_to_fq_mont`, `fq_squeeze_to_fr_mont`,
`DeviceTranscript`.  The sponge's state stays on the device as a `(3,
nlimbs)` int32 Montgomery limb tensor, so that a whole sumcheck runs without
a round trip to the host (core/sumcheck.py `_prove_fused`); the
absorb/squeeze mode machine stays in Python, static, as in the reference:
a protocol's schedule is known in advance, only the values live on the
device.

Bit-exactness with the host sponge (poseidon/sponge.py): the permutation
runs in the Montgomery domain with the constants lifted, and x -> x R is a
ring homomorphism for + and the products, so it computes the same state.
Cross-field rules (an Fq transcript through Fr sumchecks): absorbing an Fr
value into an Fq sponge re-reads its canonical integer mod q
(`fr_to_fq_mont`); an Fr challenge squeezed from an Fq sponge is the low
252 bits of the canonical squeezed element (`fq_squeeze_to_fr_mont`).

`permute` launches the hand-written Poseidon kernel (csrc/poseidon.cu) on a
CUDA tensor and runs `permute_plain`, its plain version, on a CPU tensor.
A `DeviceSponge(..., plain=True)` takes the plain versions on any device
(the round tail's plain version, device/sumcheck_kernels.py, runs on it).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..fields.bls12_377 import P, R
from ..poseidon import constants_377 as C
from . import build, packed_field
from . import field as tf
from .field import FQ, FR, LIMB_BITS, FieldSpec

_ABSORBING = 0
_SQUEEZING = 1
_T = C.RATE + C.CAPACITY
ROUNDS = C.FULL_ROUNDS + C.PARTIAL_ROUNDS


# the fields whose Poseidon constants the kernels hold (BLS12-377's Fr and
# Fq, csrc/poseidon.cuh): names of packed_field.KERNEL_FIELDS
SPONGE_FIELDS = ("fr", "fq")


def _spec_of(modulus: int) -> FieldSpec:
    if modulus == R:
        return FR
    if modulus == P:
        return FQ
    raise ValueError("unsupported sponge modulus")


@functools.lru_cache(maxsize=None)
def _mont_consts(modulus: int, device: torch.device):
    """ARK `(rounds, 3, nlimbs)` and MDS `(3, 3, nlimbs)` as Montgomery limb
    tensors of the modulus, on `device`."""
    spec = _spec_of(modulus)
    ark = spec.encode([c % modulus for row in C.ARK for c in row])
    mds = spec.encode([c % modulus for row in C.MDS for c in row])
    return (torch.as_tensor(ark, device=device).reshape(ROUNDS, _T, spec.nlimbs),
            torch.as_tensor(mds, device=device).reshape(_T, _T, spec.nlimbs))


def _is_full(rnd: int) -> bool:
    half = C.FULL_ROUNDS // 2
    return rnd < half or rnd >= half + C.PARTIAL_ROUNDS


def permute_plain(spec: FieldSpec, state: torch.Tensor) -> torch.Tensor:
    """Plain version of the Poseidon kernel: one permutation of each
    `(..., 3, nlimbs)` Montgomery state, in tensor ops over
    `field.mont_mul_plain` and `add` (full rounds, partial rounds, full
    rounds: add-round-key, S-box x^17, MDS)."""
    ark, mds = _mont_consts(spec.modulus, state.device)

    def sbox(x):
        y = x
        for _ in range(4):
            y = tf.mont_mul_plain(spec, y, y)
        return tf.mont_mul_plain(spec, y, x)

    for rnd in range(ROUNDS):
        state = tf.add(spec, state, ark[rnd].expand_as(state))
        if _is_full(rnd):
            state = sbox(state)
        else:
            state = torch.cat([sbox(state[..., :1, :]), state[..., 1:, :]], dim=-2)
        prods = tf.mont_mul_plain(spec, mds, state[..., None, :, :])  # mds[i, j] s[j]
        state = tf.add(spec, tf.add(spec, prods[..., 0, :], prods[..., 1, :]), prods[..., 2, :])
    return state


def _check_state(spec: FieldSpec, state: torch.Tensor) -> None:
    if state.dim() < 2 or tuple(state.shape[-2:]) != (_T, spec.nlimbs):
        raise ValueError(f"a {spec.name} sponge state is ({_T}, {spec.nlimbs}) limbs, got "
                         f"{tuple(state.shape)}")


def permute(spec: FieldSpec, state: torch.Tensor) -> torch.Tensor:
    """One Poseidon permutation of each `(..., 3, nlimbs)` Montgomery state
    (tpu/sponge.py:57): one launch of the Poseidon kernel for all of them on
    a CUDA tensor, `permute_plain` on a CPU tensor."""
    _check_state(spec, state)
    fid = packed_field.field_id(spec, "poseidon_permute", SPONGE_FIELDS)
    if not state.is_cuda:
        return permute_plain(spec, state)
    state = state.contiguous()
    build.require_cuda_int32("poseidon_permute", state=state)
    build.require_aligned("poseidon_permute", 16, state=state)
    out = torch.empty_like(state)
    with torch.cuda.device(state.device):
        build.launch("poseidon_permute", state.data_ptr(), out.data_ptr(), fid,
                     state.numel() // (_T * spec.nlimbs))
    return out


@dataclass
class DeviceSponge:
    """Poseidon duplex sponge with its state on the device; the mode machine
    (poseidon/sponge.py:92-155) is static Python.  `plain`: permute with
    the plain version on any device."""

    spec: FieldSpec
    state: torch.Tensor  # (3, nlimbs) Montgomery domain
    mode: int = _ABSORBING
    index: int = 0
    plain: bool = False

    @staticmethod
    def fresh(modulus: int, device) -> "DeviceSponge":
        spec = _spec_of(modulus)
        return DeviceSponge(spec, torch.zeros((_T, spec.nlimbs), dtype=torch.int32, device=device))

    @staticmethod
    def from_host(sponge, device) -> "DeviceSponge":
        """Import a host PoseidonSponge's state (canonical ints)."""
        spec = _spec_of(sponge.params.modulus)
        state = torch.as_tensor(spec.encode(list(sponge.state)), device=device)
        return DeviceSponge(spec, state, sponge.mode, sponge.index)

    def export_to_host(self, sponge, state_host: Optional[np.ndarray] = None) -> None:
        """Write back into a host PoseidonSponge; `state_host` is the
        (3, nlimbs) state already copied to the host, else it is copied."""
        sponge.state = self.spec.decode(self.state if state_host is None else state_host)
        sponge.mode = self.mode
        sponge.index = self.index

    def _permute(self) -> None:
        self.state = (permute_plain if self.plain else permute)(self.spec, self.state)

    def absorb(self, elems: List[torch.Tensor]) -> None:
        """Absorb native-field Montgomery elements (each `(nlimbs,)`)."""
        if not elems:
            return
        if self.mode == _SQUEEZING or self.index == C.RATE:
            self._permute()
            self.index = 0
        self.mode = _ABSORBING
        i = self.index
        for e in elems:
            if i == C.RATE:
                self._permute()
                i = 0
            row = C.CAPACITY + i
            state = self.state.clone()
            state[row] = tf.add(self.spec, state[row], e)
            self.state = state
            i += 1
        self.index = i

    def squeeze(self, n: int) -> List[torch.Tensor]:
        out = []
        if self.mode == _ABSORBING or self.index == C.RATE:
            self._permute()
            self.index = 0
        self.mode = _SQUEEZING
        i = self.index
        for _ in range(n):
            if i == C.RATE:
                self._permute()
                i = 0
            out.append(self.state[C.CAPACITY + i])
            i += 1
        self.index = i
        return out


_FR_BITS_USED = R.bit_length() - 1  # 252: squeeze_foreign_field semantics


def _limbs(value: int, spec: FieldSpec, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(tf._int_to_limbs(value, spec.nlimbs), device=like.device)


def fr_to_fq_mont(v_fr_mont: torch.Tensor, mul=tf.mont_mul) -> torch.Tensor:
    """Montgomery Fr (16 limbs) -> Montgomery Fq (24 limbs) of the SAME
    canonical integer (the cross-field absorb rule).  `mul` is the
    Montgomery product to use."""
    canon = mul(FR, v_fr_mont, _limbs(1, FR, v_fr_mont))  # out of Montgomery form
    ext = F.pad(canon, (0, FQ.nlimbs - FR.nlimbs))
    return mul(FQ, ext, _limbs(FQ.r2_mod_p, FQ, v_fr_mont))


def fq_squeeze_to_fr_mont(v_fq_mont: torch.Tensor, mul=tf.mont_mul) -> torch.Tensor:
    """Squeezed Montgomery Fq element -> Fr challenge (Montgomery Fr): the
    low 252 bits of the canonical value (squeeze_foreign_field)."""
    canon = mul(FQ, v_fq_mont, _limbs(1, FQ, v_fq_mont))
    nl = _FR_BITS_USED // LIMB_BITS  # 15 full limbs
    rem = _FR_BITS_USED - nl * LIMB_BITS  # 12 bits
    mask = [0xFFFF] * nl + [(1 << rem) - 1] + [0] * (FR.nlimbs - nl - 1)
    canon_fr = canon[..., : FR.nlimbs] & torch.as_tensor(mask, dtype=torch.int32,
                                                         device=canon.device)
    return mul(FR, canon_fr, _limbs(FR.r2_mod_p, FR, v_fq_mont))


class DeviceTranscript:
    """Transcript facade over DeviceSponge with the cross-field
    append/challenge rules of poseidon/transcript.py."""

    def __init__(self, sponge: DeviceSponge):
        self.sponge = sponge

    @staticmethod
    def from_host(transcript, device) -> "DeviceTranscript":
        return DeviceTranscript(DeviceSponge.from_host(transcript.sponge, device))

    def _mul(self):
        return tf.mont_mul_plain if self.sponge.plain else tf.mont_mul

    def append_fr_mont(self, v: torch.Tensor) -> None:
        """append_scalar of an Fr value (a Montgomery Fr limb vector)."""
        if self.sponge.spec is FR:
            self.sponge.absorb([v])
        else:
            self.sponge.absorb([fr_to_fq_mont(v, self._mul())])

    def challenge_fr_mont(self) -> torch.Tensor:
        """challenge_scalar(Fr) -> a Montgomery Fr limb vector."""
        e = self.sponge.squeeze(1)[0]
        if self.sponge.spec is FR:
            return e
        return fq_squeeze_to_fr_mont(e, self._mul())

    def export_to_host(self, transcript, state_host: Optional[np.ndarray] = None) -> None:
        self.sponge.export_to_host(transcript.sponge, state_host)
