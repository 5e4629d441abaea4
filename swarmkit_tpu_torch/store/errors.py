"""Store error types (reference: manager/state/store/memory.go:51-77).

The port's own copy of the JAX package's store/errors.py.
"""


class StoreError(Exception):
    pass


class ErrExist(StoreError):
    pass


class ErrNotExist(StoreError):
    pass


class ErrNameConflict(StoreError):
    pass


class ErrSequenceConflict(StoreError):
    """Update out of sequence: object version does not match stored version."""


class ErrInvalidFindBy(StoreError):
    pass


class ErrTxTooLarge(StoreError):
    """Transaction exceeds MAX_CHANGES_PER_TRANSACTION / MAX_TRANSACTION_BYTES."""
