"""The port's database plane: ``DatabaseSpec`` (shape math) and the
single-device ``Database``."""
from repro_torch.db.sharded import Database
from repro_torch.db.spec import VIEWS, DatabaseSpec, IntegrityError

__all__ = ["VIEWS", "Database", "DatabaseSpec", "IntegrityError"]
