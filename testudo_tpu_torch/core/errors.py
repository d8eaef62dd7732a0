"""Error types of the proof layers.

Counterpart of testudo_tpu/core/errors.py (itself of Testudo's
src/errors.rs); the port keeps its own copy.
"""


class ProofVerifyError(Exception):
    """Proof verification failure (errors.rs:4-14)."""


class InternalError(ProofVerifyError):
    pass


class InvalidInputLength(ProofVerifyError):
    def __init__(self, matrix_len: int, input_len: int):
        super().__init__(
            f"invalid input length: matrix {matrix_len}, input {input_len}"
        )


# R1CSError and its variants live in core/r1cs.py (InvalidIndex, InvalidScalar, ...)


def require(cond: bool, what: str) -> None:
    """A verifier's check: raise ProofVerifyError naming `what` unless
    `cond` holds."""
    if not cond:
        raise ProofVerifyError(f"check failed: {what}")
