"""The paper's own system configuration (Table 1) as named presets (port
of `repro.configs.aimm_nmp`)."""
from repro_torch.nmp.config import NMPConfig

# 4x4 memory-cube mesh, 4 MCs, 512-entry NMP tables, 256-entry page cache
PAPER_4X4 = NMPConfig()

# §7.5.1 scalability study
PAPER_8X8 = NMPConfig(mesh_x=8, mesh_y=8)

# §7.6 sensitivity sweep points
PAGE_CACHE_SWEEP = (32, 64, 128, 256)
NMP_TABLE_SWEEP = (32, 64, 128, 512)
