"""Typed configuration for the whole pipeline (a copy of
turingassembler_tpu/config.py; DeviceConfig holds the port's own device
parameters).

The reference spreads its algorithmic constants over ~80 `#define`s in a
dozen headers plus hand-parsed CLI flags (reference src/main.c:134-286,
src/attribute.h:49-71) plus runtime-initialized globals
(src/scaffolding/global_params.c:21-37).  These constants ARE the
algorithm — output parity depends on reproducing them exactly — so they
are consolidated here in one frozen dataclass hierarchy, each field cited
back to its reference definition.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


# Library types (reference src/attribute.h:23-26)
LIB_TYPE_SORTED = 0
LIB_TYPE_BIOT = 1
LIB_TYPE_UST = 2
LIB_TYPE_10X = 3

LIB_TYPE_NAMES = {
    "sorted": LIB_TYPE_SORTED,
    "bioturing": LIB_TYPE_BIOT,
    "ust": LIB_TYPE_UST,
    "10x": LIB_TYPE_10X,
}

# 10X barcode layout (reference src/attribute.h:14-15)
BARCODE_LEN_10X = 16
UMI_LEN_10X = 7


@dataclass(frozen=True)
class GraphThresholds:
    """Graph-simplification constants (reference src/assembly_graph.h:97-135)."""

    min_unroll_loop: int = 1000        # MIN_UNROLL_LOOP
    min_notice_len: int = 100          # MIN_NOTICE_LEN
    min_connect_size: int = 500        # MIN_CONNECT_SIZE

    tips_ratio_thres: float = 0.1      # TIPS_RATIO_THRES
    tips_cov_thres: float = 10.0       # TIPS_COV_THRES
    tips_len_thres: int = 150          # TIPS_LEN_THRES
    min_tips_leg: int = 200            # MIN_TIPS_LEG
    tips_hard_threshold: float = 30.0  # TIPS_HARD_THRESHOLD

    chimeric_ratio_thres: float = 0.1  # CHIMERIC_RATIO_THRES
    chimeric_cov_thres: float = 100.0  # CHIMERIC_COV_THRES
    chimeric_len_thres: int = 200      # CHIMERIC_LEN_THRES

    contig_use_barcode: int = 200      # CONTIG_USE_BARCODE
    contig_level_0: int = 500          # CONTIG_LEVEL_0
    contig_level_1: int = 3000         # CONTIG_LEVEL_1
    contig_level_2: int = 10000        # CONTIG_LEVEL_2
    max_barcode_region: int = 10000    # MAX_BARCODE_REGION
    max_read_frag_len: int = 350       # MAX_READ_FRAG_LEN

    min_contig_barcode: int = 5000     # MIN_CONTIG_BARCODE
    min_contig_barcode2: int = 500     # MIN_CONTIG_BARCODE2
    min_long_contig: int = 1000        # MIN_LONG_CONTIG
    min_contig_readpair: int = 500     # MIN_CONTIG_READPAIR

    max_pair_len: int = 700            # MAX_PAIR_LEN
    max_molecule_len: int = 30000      # MAX_MOLECULE_LEN
    min_barcode_count: int = 150       # MIN_BARCODE_COUNT
    min_readpair_count: int = 15       # MIN_READPAIR_COUNT
    min_barcode_ratio: float = 0.044   # MIN_BARCODE_RATIO
    min_sub_barcode_ratio: float = 0.022  # MIN_SUB_BARCODE_RATIO
    contig_partition_len: int = 1500   # CONTIG_PARTITION_LEN
    min_component: int = 250           # MIN_COMPONENT

    # Big-kmer 2-1-2 resolution (reference src/assembly_graph.h:19-21)
    distance_kmer: int = 60            # DISTANCE_KMER
    kmer_pair_size: int = 51           # KMER_PAIR_SIZE
    big_ksize: int = 111               # BIG_KSIZE


@dataclass(frozen=True)
class BridgeThresholds:
    """Local-assembly / gap-bridging constants (reference src/build_bridge.h:3-21)."""

    ksize_check_delta: int = 6         # KSIZE_CHECK = lk + 6
    min_path_length: int = 100         # MIN_PATH_LENGTH
    min_output_contig_len: int = 500   # MIN_OUTPUT_CONTIG_LEN
    min_match_leng: int = 4000         # MIN_MATCH_LENG
    match_thresh: int = 8000           # MATCH_THRESH
    min_unmatched_ratio: float = 0.005  # MIN_UNMATCHED_RATIO
    min_radius: int = 0                # MIN_RADIUS
    min_edge_length: int = 10000       # MIN_EDGE_LENGTH
    min_edge_length_ratio: float = 0.8  # MIN_EDGE_LENGTH_RATIO
    read_gap: int = 500                # READ_GAP
    bridge_gap: int = 1000             # BRIDGE_GAP
    min_read_map_ratio: float = 0.95   # MIN_READ_MAP_RATIO
    dump_n_len: int = 100              # DUMP_N_LEN


@dataclass(frozen=True)
class MoleculeThresholds:
    """Molecule / barcode-graph constants (reference src/cluster_molecules.h:4-11)."""

    min_edge_len: int = 500            # MIN_EDGE_LEN
    max_radius: int = 4000             # MAX_RADIUS
    max_path_len: int = 30             # MAX_PATH_LEN
    min_bc_read_count: int = 10        # MIN_BC_READ_COUNT
    max_bc_read_count: int = 88        # MAX_BC_READ_COUNT
    min_barcode_edge_count: int = 100  # MIN_BARCODE_EDGE_COUNT
    min_coverage_to_be_ignore: float = 0.25  # MIN_COVERAGE_TO_BE_IGNORE
    coverage_ratio_to_be_repeat: float = 1.75  # COVERAGE_RATIO_TO_BE_REPEAT


@dataclass(frozen=True)
class MinimizerConfig:
    """Minimizer mapping constants (reference src/attribute.h:20-21,
    src/minimizers/minimizers.h:16-18)."""

    kmer: int = 17                     # MINIMIZERS_KMER
    window: int = 17                   # MINIMIZERS_WINDOW
    ratio_of_confident: float = 0.85   # RATIO_OF_CONFIDENT
    min_number_singleton: int = 2      # MIN_NUMBER_SINGLETON


@dataclass(frozen=True)
class ScaffoldParams:
    """Scaffolding globals (reference src/scaffolding/global_params.c:21-37).

    The reference sets these from the graph at init; the values below are
    the constants assigned there (thres_length=4000, molecule=20000,
    n_candidate=11, distance=10000, count_bc_size=3000, number_n=100,
    coefficent=0.20).  genome_coverage and avg_sum_bin_hash remain
    data-dependent and are computed at scaffold time.
    """

    thres_length: int = 4000           # global_thres_length
    thres_short_len: int = 4000        # global_thres_short_len
    molecule_length: int = 20000       # global_molecule_length
    filter_constant: int = 0           # global_filter_constant
    n_candidate: int = 11              # global_n_candidate
    distance: int = 10000              # global_distance
    count_bc_size: int = 3000          # global_count_bc_size
    number_n: int = 100                # global_number_n
    thres_coefficent: float = 0.20     # global_thres_coefficent
    min_shared_barcodes: int = 75      # scaffolding/buck.c:33 get_bc_score floor


@dataclass(frozen=True)
class DeviceConfig:
    """Device execution parameters (no upstream analogue: upstream is a
    single-host pthreads program)."""

    # Reads per device batch for the streaming k-mer counter.
    reads_per_batch: int = 65536
    # Drop (k+1)-mers with count below this before graph build.  KMC's
    # default -ci is 2 in typical pipelines; the reference feeds KMC with
    # default exclusion of singletons (solid k-mer filtering).
    min_kmer_count: int = 1
    # Out-of-core count (kmer/megasort.py): rows the device table may
    # hold before it is pulled to a host run (0: no budget, the count
    # stays on the device), and megabytes of host runs before they go to
    # disk (None: Config.mmem_gb, the -sm option).
    sort_device_lanes: int = 0
    sort_host_mb: Optional[float] = None


@dataclass(frozen=True)
class Config:
    """Full pipeline configuration == reference `struct opt_proc_t`
    (src/attribute.h:49-71) + every compile-time constant."""

    # CLI-equivalent options (defaults: reference src/main.c:134-156)
    n_threads: int = 4
    hash_size: int = 1 << 24
    k0: int = 45                       # global DBG k
    lk: int = 31                       # local-assembly k
    split_len: int = 1000
    out_dir: str = "."
    mmem_gb: int = 32                  # sort-memory budget
    lib_type: int = LIB_TYPE_UST
    metagenomics: bool = False

    files_1: tuple = ()
    files_2: tuple = ()
    files_I: tuple = ()
    in_file: Optional[str] = None
    in_fasta: Optional[str] = None
    in_contig_file: Optional[str] = None
    ref_fasta: Optional[str] = None    # truth genome for `evaluate`

    graph: GraphThresholds = field(default_factory=GraphThresholds)
    bridge: BridgeThresholds = field(default_factory=BridgeThresholds)
    molecule: MoleculeThresholds = field(default_factory=MoleculeThresholds)
    minimizer: MinimizerConfig = field(default_factory=MinimizerConfig)
    scaffold: ScaffoldParams = field(default_factory=ScaffoldParams)
    device: DeviceConfig = field(default_factory=DeviceConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = Config()
