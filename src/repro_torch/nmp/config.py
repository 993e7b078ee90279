"""NMP system hardware configuration (paper Table 1) and timing constants
(port of `repro.nmp.config`).

The paper's system: 16-core CMP, 4 memory controllers at the CMP corners,
a 4x4 (scalability study: 8x8) mesh of 1 GB memory cubes (32 vaults x 8 banks,
crossbar), 3-stage routers, 128-bit links, 512-entry NMP-op tables, 128-entry
page-info caches (empirically bumped to 256 in §7.6).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NMPConfig:
    # --- topology (Table 1) ---
    # `topology` names a builder in nmp.topology.TOPOLOGIES ("mesh2d",
    # "torus2d", "ring", "dragonfly"); mesh_x/mesh_y parameterize its
    # geometry (ring: mesh_x*mesh_y cubes; dragonfly: mesh_y groups of
    # mesh_x cubes).  The routing tensors are precomputed host-side from
    # this declarative spec (nmp.topology.get_topology), so the config stays
    # hashable (one cached tensor set per geometry).
    topology: str = "mesh2d"
    mesh_x: int = 4
    mesh_y: int = 4
    n_mcs: int = 4                    # one per CMP corner
    # --- cube internals ---
    n_vaults: int = 32
    banks_per_vault: int = 8
    nmp_table_size: int = 512         # outstanding NMP-op entries per cube
    # --- AIMM hardware ---
    page_cache_entries: int = 256     # page info cache (empirical, §7.6)
    migration_queue: int = 128
    # page-info-cache history depths (paper Fig. 3; per-page hop / latency /
    # migration-latency / action histories).  Also sizes the matching state-
    # vector slices (core.state.StateSpec), so changing them changes the DQN
    # input dim.
    hop_hist: int = 8
    lat_hist: int = 8
    mig_hist: int = 4
    act_hist: int = 4
    # --- memory / network geometry ---
    page_bytes: int = 4096
    link_bytes_per_cycle: int = 16    # 128-bit links
    packet_bytes: int = 64            # one NMP data packet (cacheline)
    # --- timing model (cycles) ---
    t_router: float = 3.0             # 3-stage router pipeline per hop
    t_dram_hit: float = 15.0          # row-buffer hit access
    t_dram_miss: float = 45.0         # row activate + access
    t_op: float = 2.0                 # NMP compute service per op
    cube_issue_rate: float = 4.0      # ops/cycle a cube can drain (vault parallelism)
    mc_issue_rate: float = 2.0        # ops/cycle each MC can inject
    t_agent: float = 4.0              # AIMM action-application overhead per epoch
                                      # (agent inference runs concurrently on its
                                      #  own accelerator, §5.2 — non-blocking)
    congestion_alpha: float = 1.6     # queuing amplification on the hottest link
                                      # (M/M/1-style superlinear contention)
    t_page_walk: float = 4.0          # amortized 4-level page walk (TLB-filtered)
    # --- epochs & agent invocation intervals ---
    # Fixed-size op windows; the paper's interval actions ({100,125,167,250}
    # cycles) map to invocation strides of {1,2,3,4} epochs.
    epoch_ops: int = 128
    w_max: int = 128                  # static op-window buffer (== epoch_ops)
    # --- migration ---
    mig_blocking_stall: float = 96.0  # extra stall for blocking (RW) migration
    mig_nonblocking_stall: float = 16.0
    # --- PEI cache model ---
    pei_hot_frac: float = 0.05        # top-5% hottest pages count as CPU-cache hits
    # --- AIMM hot-page selection ---
    recent_ring: int = 2              # skip pages acted on in the last N epochs
    remap_ttl: int = 64               # compute-remap table entry lifetime (epochs)

    @property
    def n_cubes(self) -> int:
        return self.mesh_x * self.mesh_y

    @property
    def page_flits(self) -> float:
        return self.page_bytes / self.link_bytes_per_cycle  # cycles on one link

    @property
    def packet_flits(self) -> float:
        return self.packet_bytes / self.link_bytes_per_cycle

    @property
    def mc_cubes(self) -> tuple[int, ...]:
        """Cube ids adjacent to each MC (the four mesh corners)."""
        X, Y = self.mesh_x, self.mesh_y
        return (0, X - 1, X * (Y - 1), X * Y - 1)


# Energy constants (paper §7.7, CACTI 45nm + published per-bit figures).
ENERGY_NJ = {
    "page_cache_access": 0.05,
    "nmp_buffer_access": 0.122,
    "mig_queue_access": 0.02689,
    "mdma_access": 0.1062,
    "weight_access": 0.244,
    "replay_access": 2.3,
    "state_buffer_access": 0.106,
    "network_per_bit_hop": 0.005,   # 5 pJ/bit/hop
    "memory_per_bit": 0.012,        # 12 pJ/bit/access
}

# Area of the AIMM hardware (paper §7.7, CACTI 45nm).
AREA_MM2 = {
    "page_info_cache": 0.23,   # 64 KB
    "nmp_buffer": 0.14,        # 512 B
    "migration_queue": 0.04,   # 2 KB
    "mdma_buffers": 0.124,     # 1 KB
    "weight_matrix": 2.095,    # 603 KB
    "replay_buffer": 117.86,   # 36 MB
    "state_buffer": 0.12,      # 576 B
}
