from swarmkit_tpu_torch.store.errors import (
    StoreError, ErrExist, ErrNotExist, ErrNameConflict, ErrSequenceConflict,
    ErrInvalidFindBy, ErrTxTooLarge,
)
from swarmkit_tpu_torch.store.by import (
    All, ByID, ByIDPrefix, ByName, ByNamePrefix, ByService, ByNode, BySlot,
    ByDesiredState, ByTaskState, ByRole, ByMembership, ByReferencedSecret,
    ByReferencedConfig, Or, Custom,
)
from swarmkit_tpu_torch.store.memory import (
    MemoryStore, Event, EventCommit, Proposer, NopProposer, Batch,
    MAX_CHANGES_PER_TRANSACTION, MAX_TRANSACTION_BYTES,
)

__all__ = [
    "StoreError", "ErrExist", "ErrNotExist", "ErrNameConflict",
    "ErrSequenceConflict", "ErrInvalidFindBy", "ErrTxTooLarge",
    "All", "ByID", "ByIDPrefix", "ByName", "ByNamePrefix", "ByService",
    "ByNode", "BySlot", "ByDesiredState", "ByTaskState", "ByRole",
    "ByMembership", "ByReferencedSecret", "ByReferencedConfig", "Or", "Custom",
    "MemoryStore", "Event", "EventCommit", "Proposer", "NopProposer", "Batch",
    "MAX_CHANGES_PER_TRANSACTION", "MAX_TRANSACTION_BYTES",
]
