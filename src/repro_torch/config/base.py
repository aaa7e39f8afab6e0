"""``PIRConfig`` and ``MeshConfig``: the port's copies of
``repro.config.base``'s.

The reference resolves ``share_kind`` through its own protocol registry,
which imports JAX, so the port keeps its own dataclass with the same field
names and defaults: one spec (``dataclasses.asdict`` of either) builds
both sides. ``share_kind`` resolves against ``repro_torch``'s registry.
``MeshConfig`` is the grid ``runtime/elastic.plan_mesh`` returns.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Tuple


def _implied_share_kind(protocol_name: str) -> str:
    """Share algebra from a protocol name, for names the port has not
    registered yet (the reference's naming convention)."""
    if "additive" in protocol_name:
        return "additive"
    if "lwe" in protocol_name:
        return "lwe"
    return "xor"


@dataclass(frozen=True)
class PIRConfig:
    """One PIR database + protocol choices (same fields as the reference).

    ``mode`` is the reference's deprecated constructor alias; the port
    accepts only its normalized value ``""`` and names schemes by
    ``protocol`` (``""`` means ``xor-dpf-2``).
    """
    n_items: int                   # N: number of DB records (power of two)
    item_bytes: int = 32           # L: record payload (paper: 32-byte hashes)
    mode: str = ""                 # deprecated alias in the reference; "" only
    protocol: str = ""             # registry name; "" -> xor-dpf-2
    n_servers: int = 2             # parties
    clusters: int = 1              # DPU clusters (paper §3.4)
    batch_queries: int = 32        # concurrent queries per step
    prf: str = "chacha12"          # chacha12 | chacha8 | chacha20
    fused_kernel: bool = False     # fused GGM-expand + dpXOR (beyond paper)
    checksum: bool = False         # verified reconstruction (row checksum)
    batch_m: int = 0               # batch PIR: m records per round (BatchPIR)
    cuckoo_c: float = 2.0
    cuckoo_hashes: int = 3
    cuckoo_seed: int = 0x5EEDBA11

    def __post_init__(self):
        if self.mode:
            raise ValueError(
                f"PIRConfig(mode={self.mode!r}) is the reference's deprecated "
                "alias; name the scheme with protocol= instead")
        if not self.protocol:
            object.__setattr__(self, "protocol", "xor-dpf-2")

    @property
    def share_kind(self) -> str:
        """``xor`` | ``additive`` | ``lwe``: the registered protocol's, else
        the naming convention for schemes the port has not registered."""
        from repro_torch.core.protocol import get
        try:
            return get(self.protocol).share_kind
        except KeyError:
            return _implied_share_kind(self.protocol)

    @property
    def log_n(self) -> int:
        return (self.n_items - 1).bit_length()

    @property
    def db_bytes(self) -> int:
        return self.n_items * self.item_bytes

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class MeshConfig:
    """A device grid: axis sizes and names (``("data", "model")``, with a
    leading ``"pod"`` axis for several pods)."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    def to_dict(self) -> dict:
        return asdict(self)
