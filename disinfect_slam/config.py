"""Engine configuration for the TSDF reconstruction stack.

The reference engine (disinfect-slam) hard-codes its capacities:
  - hash table: 2^21 buckets x 2 entries (utils/tsdf/voxel_hash.cuh:13-25)
  - voxel pool: 2^18 blocks x 8^3 voxels   (utils/tsdf/voxel_mem.cuh:11-20)
  - carve threshold 0.9                    (utils/tsdf/voxel_tsdf.cu:485)
  - weight clamp 40                        (utils/tsdf/voxel_tsdf.cu:192)

Here every capacity is a config knob so the same jitted program scales from
tiny CPU test volumes to full device-resident volumes.  All shapes derived
from this config are static, keeping XLA happy (one compilation per config).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TSDFConfig:
    """Static configuration of a TSDF volume.

    Coordinates: world points are mapped to an integer voxel grid
    (pos_world / voxel_size, rounded), voxels are grouped into 8^3 blocks
    (block coord = voxel coord >> 3), and blocks live in a spatial hash.
    """

    # --- metric parameters (reference: TSDFGrid ctor voxel_tsdf.cu:309) ---
    voxel_size: float = 0.01
    truncation: float = 0.06

    # --- capacities (all powers of two) ---
    # log2 number of hash buckets (reference: 21)
    num_buckets_log2: int = 18
    # log2 entries per bucket (reference: 1 -> 2 entries)
    entries_per_bucket_log2: int = 1
    # log2 number of voxel blocks in the pool (reference: 18)
    num_blocks_log2: int = 16
    # log2 of block side length (reference: 3 -> 8^3 = 512 voxels)
    block_len_log2: int = 3

    # --- batch-insert machinery (replaces the bucket spin locks) ---
    # linear probe window per lookup/insert
    max_probe: int = 16
    # unique candidate blocks considered for allocation per frame
    max_candidates: int = 16384
    # claim rounds for conflict resolution; unresolved candidates are
    # dropped for this frame (mirrors the reference's fail-open lock retry,
    # voxel_hash.cu:83-89)
    insert_rounds: int = 3
    # compacted winner capacity per insert round (pool rows reset per frame)
    max_new_per_round: int = 4096

    # --- per-frame working set ---
    # max visible blocks gathered for fusion / carving per frame
    max_visible: int = 16384

    # --- fusion constants (voxel_tsdf.cu:174-202, 485) ---
    max_weight: float = 40.0
    carve_threshold: float = 0.9
    # clamp fused probabilities to [eps, 1-eps]; 0.0 reproduces the
    # reference exactly (which can drive prob to 0/1 and then NaN via
    # log(0) with a zero weight, voxel_tsdf.cu:196-202) — production
    # configs should set ~1e-6
    prob_eps: float = 0.0

    # --- coordinate packing for dedup keys ---
    # bits per axis when packing a block coord into one int32; block coords
    # must lie in [-2^(bits-1), 2^(bits-1)).  10 bits => +/-512 blocks =>
    # +/-40.9 m extent at 1 cm voxels, +/-16.4 m at 4 mm.
    coord_bits: int = 10

    # --- spatial index backend ---
    # "hash":  open-addressing spatial hash (reference-parity semantics,
    #          unbounded coordinates up to coord_bits)
    # "dense": dense block->pool table, one gather per lookup instead
    #          of a 16-slot probe; costs 4 B per grid cell of device
    #          memory and bounds the scene to 2^grid_log2 blocks per
    #          axis.
    backend: str = "dense"
    # dense grid side length in blocks (log2); 8 -> 256^3 cells = 67 MB,
    # 256 blocks * 8 voxels * 4 mm = +/-4.1 m from the origin; 9 ->
    # 512^3 = 536 MB, +/-8.2 m at 4 mm (use for large scenes — the
    # reference's hash maps unbounded coords, voxel_hash.cuh:13-25; the
    # "hash" backend here does too, up to coord_bits)
    grid_log2: int = 8
    # block coordinate of the dense grid's minimum corner; None centers
    # the grid on the world origin (-grid_side/2 per axis).  A robot
    # mapping a corridor from its start point sets this off-center so
    # the grid covers the driven direction instead of splitting its
    # extent symmetrically.
    grid_origin: tuple | None = None

    # --- fusion-path options ---
    # conservatively skip fusing blocks fully occluded by nearer surface
    # (max-range mipmap test; exact — culled blocks provably have no
    # voxel passing the sdf > -truncation gate)
    cull_occluded: bool = False
    # raycast empty-space skipping: jump whole steps across unallocated
    # blocks (bit-identical output — skipped samples provably read the
    # default +1).  Off reproduces the brute-force march for A/B timing.
    raycast_skip: bool = True
    # allocation dedup strategy:
    # "sort":   jnp.unique over packed keys (any backend)
    # "filter": dense backend only — presence-check against the block
    #           table, then compact only the (few) genuinely-new keys;
    #           skips the ~1M-key sort entirely.
    alloc_dedup: str = "filter"
    # Pass indices_are_sorted/unique_indices promises to XLA on the hot
    # payload row gathers/scatters (ops/integrate.py, ops/render_fast.py,
    # ops/gather.py).  The promises provably hold (dense pool indices are
    # ascending through compaction; scatter padding uses distinct OOB
    # values — pinned by test_visible_pool_indices_sorted_unique_invariant),
    # so this is semantics-free; the flag exists for hardware A/B and as
    # a kill switch if a backend miscompiles the hinted emitters
    # (chip_smoke.py cross-checks on/off bit-exact on the GPU, where
    # unique_indices lets XLA drop the scatter's atomics).
    index_hints: bool = True
    # Windowed fuse scatter: route the three per-frame payload
    # write-backs through a 2^k-row window sliced around the (ascending)
    # live pool rows — the scatter operand becomes O(window), independent
    # of pool capacity, at the cost of one dynamic_slice +
    # dynamic_update_slice round trip per array (~2*W*2 KB of extra
    # device-memory traffic each).  Dense backend only (needs the
    # sorted-live-prefix invariant); falls back to the plain full-pool
    # scatter in-program (lax.cond) when the live row span exceeds the
    # window.  0 = off (the plain scatter).
    scatter_window_log2: int = 0
    # Allocation-DDA pixel stride: candidate blocks are generated from
    # every s-th pixel in x and y (s*s fewer candidate keys).  Coverage
    # is exact while every visible block's screen footprint spans >= s
    # px, i.e. s <= fx * block_len * voxel_size / max_depth (4.2 px at
    # fx=525, 32 mm blocks, 4 m max depth -> stride 2 loses nothing
    # there); a block grazed by a single finer-than-stride ray defers to
    # a later frame (fail-open, like the reference's lock-miss drop,
    # voxel_hash.cu:83-89).
    alloc_stride: int = 1
    # Fuse-tail ladder: compile the post-gather fuse tail (payload row
    # gathers + fusion math + scatters + carve reduce) at L static row
    # sizes — max_visible * k / L for k = 1..L — and lax.cond-select the
    # smallest size covering the live visible count each frame; the tail
    # otherwise runs at the padded max_visible cap.  Branch outputs are
    # identical by construction (rows past the count are masked
    # everywhere), but each branch compiles separately, so cross-branch
    # float results agree only to the usual per-program-shape ulp bound
    # (same contract class as scatter_window_log2).  1 = monolithic
    # (exact reference shape); -1 = auto (resolves to 1).  Compile time
    # scales with L.
    fuse_ladder: int = 1
    # Allocate on every N-th frame only (fusion still runs every frame).
    # The allocation pass is a no-op whenever no new surface entered the
    # view; skipping it defers
    # first-seen geometry by at most N-1 frames — the same fail-open
    # latency class as alloc_stride and the reference's lock-miss drop
    # (voxel_hash.cu:83-89).  Consumed by systems/tsdf_grid.py and
    # bench.py (ops/integrate.py integrate(allocate=False) is the
    # primitive); 1 = reference-exact every-frame allocation.
    alloc_every: int = 1

    # ------------------------------------------------------------------
    @property
    def block_len(self) -> int:
        return 1 << self.block_len_log2

    @property
    def block_volume(self) -> int:
        return 1 << (3 * self.block_len_log2)

    @property
    def num_buckets(self) -> int:
        return 1 << self.num_buckets_log2

    @property
    def entries_per_bucket(self) -> int:
        return 1 << self.entries_per_bucket_log2

    @property
    def num_entries(self) -> int:
        # dense backend: the pool IS the entry list (slot i <-> pool i)
        if self.backend == "dense":
            return 1 << self.num_blocks_log2
        return 1 << (self.num_buckets_log2 + self.entries_per_bucket_log2)

    @property
    def entry_mask(self) -> int:
        return self.num_entries - 1

    @property
    def bucket_mask(self) -> int:
        return self.num_buckets - 1

    @property
    def num_blocks(self) -> int:
        return 1 << self.num_blocks_log2

    @property
    def coord_min(self) -> int:
        return -(1 << (self.coord_bits - 1))

    @property
    def coord_max(self) -> int:
        return (1 << (self.coord_bits - 1)) - 1

    def refine_iters(self, step_size: float) -> int:
        """Static iteration count for raycast binary refinement.

        The reference refines while the squared endpoint gap (in voxels)
        exceeds 0.1 (voxel_tsdf.cu:265); the gap quarters per iteration.
        """
        gap_sq = (step_size / self.voxel_size) ** 2
        iters = 0
        while gap_sq > 0.1 and iters < 16:
            gap_sq /= 4.0
            iters += 1
        return max(iters, 1)

    @property
    def grid_side(self) -> int:
        return 1 << self.grid_log2

    @property
    def grid_cells(self) -> int:
        return 1 << (3 * self.grid_log2)

    def validate(self) -> None:
        assert self.truncation > self.voxel_size
        assert 3 * self.coord_bits <= 30, "packed block coord must fit int32"
        assert self.backend in ("hash", "dense")
        assert self.scatter_window_log2 >= 0, self.scatter_window_log2
        assert self.alloc_stride >= 1, self.alloc_stride
        assert self.alloc_every >= 1, (
            "alloc_every is a cadence (1 = allocate every frame); "
            f"got {self.alloc_every}"
        )
        assert self.fuse_ladder == -1 or self.fuse_ladder >= 1, self.fuse_ladder
        if self.fuse_ladder > 1:
            assert self.max_visible % self.fuse_ladder == 0, (
                "fuse_ladder must divide max_visible evenly; got "
                f"{self.fuse_ladder} vs {self.max_visible}"
            )
        if self.backend == "hash":
            assert self.max_probe >= self.entries_per_bucket
            assert self.num_blocks <= self.num_entries
        else:
            assert self.grid_log2 <= self.coord_bits
            if self.grid_origin is not None:
                assert len(self.grid_origin) == 3
                for o in self.grid_origin:
                    assert (
                        self.coord_min <= o
                        and o + self.grid_side - 1 <= self.coord_max
                    ), "grid [origin, origin+side) must fit the packed coord range"


# Small config for unit tests / CPU interpretation.
TINY = TSDFConfig(
    num_buckets_log2=8,
    num_blocks_log2=8,
    max_probe=8,
    max_candidates=512,
    max_visible=256,
    max_new_per_round=256,
    backend="hash",
)

TINY_DENSE = TSDFConfig(
    num_blocks_log2=8,
    max_candidates=512,
    max_visible=256,
    max_new_per_round=256,
    backend="dense",
    grid_log2=5,
)

# Default single-chip config mirroring the reference's offline example
# (examples/tsdf/offline.cc:90 uses voxel 0.01 m, truncation 0.06 m).
DEFAULT = TSDFConfig()
