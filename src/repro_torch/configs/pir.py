"""PIR database configurations of the port's multi-server schemes.

The same points as ``repro/configs/pir.py``: records are 32-byte hashes
and DB sizes follow the paper's 0.5–8 GB sweep (§5.2, Figure 9), so
``n_items`` = db_bytes / 32 is a power of two (the GGM tree domain).
``PIR_1G`` and its ``additive-dpf-2`` and ``xor-dpf-k`` twins
(``PIR_1G_ADD``, ``PIR_1G_K3``: the same records) are the points the port
is measured at on one H100.
"""
from repro_torch.config import PIRConfig

# paper evaluation points (Figure 9): 0.5, 1, 2, 4, 8 GB
PIR_512M = PIRConfig(n_items=1 << 24, item_bytes=32)
PIR_1G = PIRConfig(n_items=1 << 25, item_bytes=32)
PIR_2G = PIRConfig(n_items=1 << 26, item_bytes=32)
PIR_4G = PIRConfig(n_items=1 << 27, item_bytes=32)
PIR_8G = PIRConfig(n_items=1 << 28, item_bytes=32)

# additive-share protocol (the batched int8 GEMM path, beyond-paper)
PIR_1G_ADD = PIRConfig(n_items=1 << 25, item_bytes=32,
                       protocol="additive-dpf-2")

# k-server XOR at 1 GB (beyond-paper; k = n_servers)
PIR_1G_K3 = PIRConfig(n_items=1 << 25, item_bytes=32,
                      protocol="xor-dpf-k", n_servers=3)

# small scale for tests and the quickstart
PIR_SMOKE = PIRConfig(n_items=1 << 14, item_bytes=32, batch_queries=4)
PIR_SMOKE_ADD = PIRConfig(n_items=1 << 14, item_bytes=32,
                          protocol="additive-dpf-2", batch_queries=4)
PIR_SMOKE_K3 = PIRConfig(n_items=1 << 12, item_bytes=32,
                         protocol="xor-dpf-k", n_servers=3, batch_queries=4)

PIR_CONFIGS = {
    "pir-512m": PIR_512M,
    "pir-1g": PIR_1G,
    "pir-2g": PIR_2G,
    "pir-4g": PIR_4G,
    "pir-8g": PIR_8G,
    "pir-1g-add": PIR_1G_ADD,
    "pir-1g-k3": PIR_1G_K3,
    "pir-smoke": PIR_SMOKE,
    "pir-smoke-add": PIR_SMOKE_ADD,
    "pir-smoke-k3": PIR_SMOKE_K3,
}
