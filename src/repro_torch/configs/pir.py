"""PIR database configurations of the port.

The same points as ``repro/configs/pir.py``: records are 32-byte hashes
and DB sizes follow the paper's 0.5–8 GB sweep (§5.2, Figure 9), so
``n_items`` = db_bytes / 32 is a power of two (the GGM tree domain).
``PIR_1G`` and its ``additive-dpf-2`` and ``xor-dpf-k`` twins
(``PIR_1G_ADD``, ``PIR_1G_K3``: the same records) are the points the port
is measured at on one H100.

The single-server LWE scheme is measured at ``PIR_128M_LWE`` (2^22
records, 128 MiB), not at the reference's ``PIR_1G_LWE``, which is not a
port config: its public matrix A (N x n int32 with n = 1024 from the
parameter table) would be 128 GiB at 2^25 rows, more than one card's
80 GB, and both the client (A.s per query) and the hint (A^T.D) need A
resident. At 2^22 rows A is 16 GiB; the record width, the parameter row
(n = 1024, sigma = 0.5) and the scheme are the 1 GiB point's own, and
only N is cut.
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

# single-server LWE (beyond-paper; no non-collusion assumption), cut from
# the reference's 1 GiB point to 2^22 rows so that A fits on one card
PIR_128M_LWE = PIRConfig(n_items=1 << 22, item_bytes=32,
                         protocol="lwe-simple-1", n_servers=1)

# small scale for tests and the quickstart
PIR_SMOKE = PIRConfig(n_items=1 << 14, item_bytes=32, batch_queries=4)
PIR_SMOKE_ADD = PIRConfig(n_items=1 << 14, item_bytes=32,
                          protocol="additive-dpf-2", batch_queries=4)
PIR_SMOKE_K3 = PIRConfig(n_items=1 << 12, item_bytes=32,
                         protocol="xor-dpf-k", n_servers=3, batch_queries=4)
PIR_SMOKE_LWE = PIRConfig(n_items=1 << 14, item_bytes=32,
                          protocol="lwe-simple-1", n_servers=1,
                          batch_queries=4)
# replica-plane smoke (the replicas twin): every replica holds its own
# database and plans, so the fleet demo runs the cheap LWE step at 2^12
# records
PIR_SMOKE_REPL = PIRConfig(n_items=1 << 12, item_bytes=32,
                           protocol="lwe-simple-1", n_servers=1,
                           batch_queries=4)
# verified reconstruction (the reference's chaos smoke): the per-row
# checksum column on the single-server scheme, so that a corrupted answer
# raises IntegrityError instead of decoding to garbage
PIR_SMOKE_CHK = PIRConfig(n_items=1 << 12, item_bytes=32,
                          protocol="lwe-simple-1", n_servers=1,
                          batch_queries=4, checksum=True)
# online-update smoke (the db_updates twin): three-server updates at
# 2^10 records, batches of 2
PIR_SMOKE_UPD = PIRConfig(n_items=1 << 10, item_bytes=32,
                          protocol="xor-dpf-k", n_servers=3,
                          batch_queries=2)
# batch-PIR smoke (the batch_query twin, tests): m = 4 indices per round
# cuckoo-hashed into B = 8 buckets; checksums on, so verified
# reconstruction rides through reassembly
PIR_SMOKE_BATCH = PIRConfig(n_items=1 << 10, item_bytes=32,
                            batch_m=4, batch_queries=1, checksum=True)
# the batch plane at the 1 GiB point: 256-record rounds over B = 512
# buckets (the reference's PIR_1G_BATCH)
PIR_1G_BATCH = PIRConfig(n_items=1 << 25, item_bytes=32, batch_m=256)

PIR_CONFIGS = {
    "pir-512m": PIR_512M,
    "pir-1g": PIR_1G,
    "pir-2g": PIR_2G,
    "pir-4g": PIR_4G,
    "pir-8g": PIR_8G,
    "pir-1g-add": PIR_1G_ADD,
    "pir-1g-k3": PIR_1G_K3,
    "pir-128m-lwe": PIR_128M_LWE,
    "pir-smoke": PIR_SMOKE,
    "pir-smoke-add": PIR_SMOKE_ADD,
    "pir-smoke-k3": PIR_SMOKE_K3,
    "pir-smoke-upd": PIR_SMOKE_UPD,
    "pir-smoke-lwe": PIR_SMOKE_LWE,
    "pir-smoke-repl": PIR_SMOKE_REPL,
    "pir-smoke-chk": PIR_SMOKE_CHK,
    "pir-smoke-batch": PIR_SMOKE_BATCH,
    "pir-1g-batch": PIR_1G_BATCH,
}
