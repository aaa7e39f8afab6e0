"""The port's database plane: ``DatabaseSpec`` (shape math and the
checksum column of verified reconstruction) and the single-device
``Database``."""
from repro_torch.db.sharded import Database
from repro_torch.db.spec import (VIEWS, DatabaseSpec, IntegrityError,
                                 row_checksum, verify_records)

__all__ = ["VIEWS", "Database", "DatabaseSpec", "IntegrityError",
           "row_checksum", "verify_records"]
