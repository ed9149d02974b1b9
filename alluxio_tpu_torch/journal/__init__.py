"""Journaled metadata durability (reference: ``core/server/common/.../journal``)."""

from alluxio_tpu_torch.journal.format import EntryType, JournalEntry, Journaled  # noqa: F401
from alluxio_tpu_torch.journal.system import (  # noqa: F401
    JournalContext, JournalSystem, LocalJournalSystem, NoopJournalSystem,
    create_journal_system,
)
