"""The port's database plane: ``DatabaseSpec`` (shape math and the
checksum column of verified reconstruction), the single-device
``Database`` with epoched ``stage`` / ``publish`` updates, and the batch
plane's ``BucketedDatabase``."""
from repro_torch.db.sharded import Database, PublishedDelta, TransferStats
from repro_torch.db.spec import (VIEWS, DatabaseSpec, IntegrityError,
                                 row_checksum, verify_records)
from repro_torch.db.bucketed import BucketedDatabase

__all__ = ["VIEWS", "BucketedDatabase", "Database", "DatabaseSpec",
           "IntegrityError", "PublishedDelta", "TransferStats",
           "row_checksum", "verify_records"]
