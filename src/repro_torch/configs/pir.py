"""PIR database configurations of the ``xor-dpf-2`` slice.

The same points as ``repro/configs/pir.py``: records are 32-byte hashes
and DB sizes follow the paper's 0.5–8 GB sweep (§5.2, Figure 9), so
``n_items`` = db_bytes / 32 is a power of two (the GGM tree domain).
``PIR_1G`` is the point the port is measured at on one H100.
"""
from repro_torch.config import PIRConfig

# paper evaluation points (Figure 9): 0.5, 1, 2, 4, 8 GB
PIR_512M = PIRConfig(n_items=1 << 24, item_bytes=32)
PIR_1G = PIRConfig(n_items=1 << 25, item_bytes=32)
PIR_2G = PIRConfig(n_items=1 << 26, item_bytes=32)
PIR_4G = PIRConfig(n_items=1 << 27, item_bytes=32)
PIR_8G = PIRConfig(n_items=1 << 28, item_bytes=32)

# small scale for tests and the quickstart
PIR_SMOKE = PIRConfig(n_items=1 << 14, item_bytes=32, batch_queries=4)

PIR_CONFIGS = {
    "pir-512m": PIR_512M,
    "pir-1g": PIR_1G,
    "pir-2g": PIR_2G,
    "pir-4g": PIR_4G,
    "pir-8g": PIR_8G,
    "pir-smoke": PIR_SMOKE,
}
