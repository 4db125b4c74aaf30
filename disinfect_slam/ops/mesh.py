"""Surface mesh extraction from the TSDF volume.

The reference delegates meshing to external tools: KrisLibrary's
SparseTSDFReconstruction::ExtractMesh in the ROS path
(examples/ros_camera_driver/ros_offline.cc:279-287) and the offline
TSDF2Mesh consumer of the /tmp/data.bin dump (README.md:69, 91).  This
module makes the framework self-contained with a *marching tetrahedra*
extractor — chosen over classic marching cubes because its case tables
are derivable from first principles (6 tetrahedra per cell, 16 sign
cases each, no large lookup tables) and the whole extraction vectorizes
into plain gathers/selects that XLA maps well onto the VPU.

Vertices land on zero-crossings by linear interpolation, matching the
sub-voxel surface placement the raycaster's bisection refinement finds.
Output is a fixed-capacity triangle soup + count (jit-friendly); use
`compact_mesh` on host for the trimmed arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..core import voxel as vx
from ..core.state import TSDFVolume
from . import hash as h
from .integrate import compact_mask

# The 6 tetrahedra of a unit cell, as corner indices into the cube's 8
# corners (corner c = (x, y, z) bits = (c&1, (c>>1)&1, (c>>2)&1)).
# This decomposition shares the main diagonal 0-7 so faces are consistent
# across neighboring tetrahedra.
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    np.int32,
)

_CORNER_OFFSETS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int32
)

# Tetrahedron edge list: the 6 edges as (corner_a, corner_b) local
# indices 0..3 within a tet.
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32
)


def _build_tet_tables():
    """Derive the 16-case marching-tetrahedra triangle table.

    Case bit i set <=> corner i is inside (tsdf < 0).  Each case yields
    0, 1, or 2 triangles, each triangle as 3 edge indices into _TET_EDGES
    (-1 padding).  Orientation: triangles wind so normals point toward
    the positive (outside) region, consistent with tsdf > 0 = outside.
    """
    # edge index lookup by corner pair
    eidx = {}
    for k, (a, b) in enumerate(_TET_EDGES):
        eidx[(a, b)] = k
        eidx[(b, a)] = k

    table = -np.ones((16, 2, 3), np.int32)
    for case in range(1, 15):
        inside = [i for i in range(4) if case & (1 << i)]
        outside = [i for i in range(4) if not case & (1 << i)]
        if len(inside) == 1:
            (a,) = inside
            b, c, d = outside
            # one triangle on edges a-b, a-c, a-d
            table[case, 0] = [eidx[(a, b)], eidx[(a, c)], eidx[(a, d)]]
        elif len(inside) == 3:
            (a,) = outside
            b, c, d = inside
            table[case, 0] = [eidx[(a, b)], eidx[(a, d)], eidx[(a, c)]]
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            # quad on edges (a,c), (a,d), (b,d), (b,c) -> two triangles
            q = [eidx[(a, c)], eidx[(a, d)], eidx[(b, d)], eidx[(b, c)]]
            table[case, 0] = [q[0], q[1], q[2]]
            table[case, 1] = [q[0], q[2], q[3]]
    return table


_TET_TABLE = _build_tet_tables()
_NUM_TRIS = np.array(
    [np.sum(_TET_TABLE[c, :, 0] >= 0) for c in range(16)], np.int32
)


class Mesh(NamedTuple):
    vertices: jnp.ndarray  # f32 [max_tris, 3, 3] world metres
    valid: jnp.ndarray  # bool [max_tris]
    count: jnp.ndarray  # i32 []


def extract_mesh(vol: TSDFVolume, max_tris: int = 1 << 18) -> Mesh:
    """Triangle soup of the zero isosurface over all live blocks.

    Cells with any unobserved corner (weight == 0 or unallocated) are
    skipped so the initial-value tsdf never fabricates surface.

    NOTE: this single-shot variant materializes buffers proportional to
    cfg.max_visible x 512 x 12 triangles; for big volumes prefer
    extract_mesh_chunked (bounded memory, loops on host).
    """
    cfg = vol.cfg
    live = vol.entry_block >= 0
    vis = compact_mask(vol, live)
    return _extract_from_blocks(
        vol, vis.block_pos, vis.pool_idx, vis.mask, max_tris
    )


def extract_mesh_chunked(
    vol: TSDFVolume,
    max_tris_per_chunk: int = 1 << 18,
    chunk: int = 512,
    transfer: str = "f32",
    bucket: int = 4096,
):
    """Memory-bounded extraction: iterates the candidate blocks in
    fixed-size chunks (one compiled program reused across chunks) and
    concatenates compacted host triangles.  Returns [N, 3, 3] float32.

    Blocks that provably produce no triangles (single-signed corner
    field, bounded conservatively through neighbors) are skipped before
    chunking.

    The D2H side is pipelined: chunk counts come back in ONE batched
    read, transfer slices are padded up to `bucket` rows so
    the slice programs specialize to a bounded shape set, and every
    chunk's copy is started async before the first is consumed.

    transfer="q16" additionally quantizes vertices on device to uint16
    voxel-grid fixed point (1/16 voxel step => max error 1/32 voxel,
    ~0.13 mm at 4 mm voxels) — 2x fewer D2H bytes; dequantized on host.
    Side effect: downstream merge_vertices collapses sliver triangles
    thinner than the step (vertices snap together), shrinking the face
    count at identical geometry (verified: NN deviation < step on the
    offline CLI A/B).
    Falls back to f32 when the volume extent exceeds the u16 range
    (65535 steps ~ 16 m at 4 mm)."""
    import jax
    import jax.numpy as jnp

    cfg = vol.cfg

    @jax.jit
    def _candidates(v):
        live_d = v.entry_block >= 0
        pool_d = jnp.clip(v.entry_block, 0, cfg.num_blocks - 1)
        rows = v.tsdf[pool_d]
        bmin = jnp.where(live_d, jnp.min(rows, axis=1), jnp.inf)
        bmax = jnp.where(live_d, jnp.max(rows, axis=1), -jnp.inf)
        fmin, fmax = bmin, bmax
        for d in ((1, 0, 0), (0, 1, 0), (0, 0, 1),
                  (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1)):
            ncoord = v.entry_pos + jnp.asarray(d, jnp.int32)
            npool = h.lookup(v, ncoord)
            nhit = (npool >= 0) & live_d
            nrows = v.tsdf[jnp.clip(npool, 0, cfg.num_blocks - 1)]
            fmin = jnp.where(nhit, jnp.minimum(fmin, jnp.min(nrows, axis=1)),
                             fmin)
            fmax = jnp.where(nhit, jnp.maximum(fmax, jnp.max(nrows, axis=1)),
                             fmax)
        # fmax >= 0 (not > 0) to match the cell emission predicate
        # (corner >= 0): a block whose field max is exactly 0.0 still
        # emits (degenerate) cells in the single-shot path
        return live_d & (fmin < 0) & (fmax >= 0)

    cand = np.asarray(_candidates(vol))

    block_pos = np.asarray(vol.entry_pos)[cand]
    pool_idx = np.asarray(vol.entry_block)[cand]
    n = len(pool_idx)
    if n == 0:
        return np.zeros((0, 3, 3), np.float32)

    fn = jax.jit(
        lambda v, bp, pi, m: _extract_from_blocks(v, bp, pi, m, max_tris_per_chunk)
    )
    # dispatch every chunk before reading any back: device work and the
    # D2H transfers pipeline instead of ping-ponging per chunk
    # q16 transfer frame: global origin from the candidate blocks (host
    # data already present), fixed-point step = voxel/16
    q_origin = q_step = None
    if transfer == "q16":
        bl = cfg.block_len
        lo = block_pos.min(axis=0).astype(np.float64) * bl * cfg.voxel_size
        hi = (block_pos.max(axis=0).astype(np.float64) + 1) * bl * cfg.voxel_size
        step = cfg.voxel_size / 16.0
        if float((hi - lo).max()) / step < 65534.0:
            q_origin, q_step = lo.astype(np.float32), np.float32(step)
        # else: extent exceeds u16 range -> silent f32 fallback

        if q_origin is not None:
            org_j = jnp.asarray(q_origin)

            @jax.jit
            def _quant(verts):
                q = jnp.round((verts - org_j) / q_step)
                return jnp.clip(q, 0, 65535).astype(jnp.uint16)

    meshes = []
    for s0 in range(0, n, chunk):
        bp = np.zeros((chunk, 3), np.int32)
        pi = np.full((chunk,), vol.cfg.num_blocks, np.int32)
        m = np.zeros((chunk,), bool)
        sel = slice(s0, min(s0 + chunk, n))
        k = sel.stop - sel.start
        bp[:k] = block_pos[sel]
        pi[:k] = pool_idx[sel]
        m[:k] = True
        mesh = fn(vol, jnp.asarray(bp), jnp.asarray(pi), jnp.asarray(m))
        if q_origin is not None:
            mesh = mesh._replace(vertices=_quant(mesh.vertices))
        meshes.append(mesh)

    # ONE batched count read instead of a sync per chunk
    counts = np.asarray(jnp.stack([m.count for m in meshes]))
    clipped = int(np.sum(counts >= max_tris_per_chunk))
    slices = []
    for mesh, cnt in zip(meshes, counts):
        cnt = int(min(cnt, max_tris_per_chunk))
        # bucketed slice: bounded shape set -> bounded compile set, and
        # a paddable extent the async copy can start on immediately
        cb = min((cnt + bucket - 1) // bucket * bucket, max_tris_per_chunk)
        slices.append((mesh.vertices[:cb], cnt))
    for arr, _ in slices:
        try:
            arr.copy_to_host_async()
        except AttributeError:  # pragma: no cover - backend-dependent
            pass
    outs = []
    for arr, cnt in slices:
        a = np.asarray(arr)[:cnt]
        if q_origin is not None:
            a = q_origin + a.astype(np.float32) * q_step
        outs.append(a)
    if clipped:
        import logging

        logging.getLogger(__name__).warning(
            "mesh extraction clipped %d/%d chunks at %d tris; "
            "lower `chunk` or raise `max_tris_per_chunk` for the full mesh",
            clipped, len(meshes), max_tris_per_chunk)
    return np.concatenate(outs, axis=0)


def _block_fields(vol, block_pos, pool_idx, mask):
    """Assemble per-block (bl+1)^3 tsdf + observed fields from pool row
    gathers and the 7 positive-neighbor blocks' boundary slabs — static
    slices and pastes only: the same sampling as per-corner-point
    read_voxels + [V, 512, 8] advanced-indexing gathers, done as whole
    row gathers instead.

    Field layout: [V, z, y, x] with 9 per axis (in-block voxel index is
    x + 8y + 64z, core/voxel.py index_to_offset).  Missing neighbors
    fill with the default payload (tsdf=+1, weight=0 -> unobserved),
    matching Retrieve's default-on-miss (voxel_hash.cuh:104-112)."""
    from ..core.state import DEFAULT_TSDF

    cfg = vol.cfg
    bl = cfg.block_len
    vcap = block_pos.shape[0]
    s = bl + 1

    def rows_of(pool, hit):
        p = jnp.clip(pool, 0, cfg.num_blocks - 1)
        t = jnp.where(hit[:, None], vol.tsdf[p], DEFAULT_TSDF)
        w = jnp.where(
            hit[:, None], (vol.rgbw[p] >> 24).astype(jnp.float32), 0.0
        )
        return (t.reshape(vcap, bl, bl, bl), w.reshape(vcap, bl, bl, bl))

    own_hit = mask & (pool_idx >= 0) & (pool_idx < cfg.num_blocks)
    t_own, w_own = rows_of(pool_idx, own_hit)

    tf = jnp.full((vcap, s, s, s), DEFAULT_TSDF, jnp.float32)
    wf = jnp.zeros((vcap, s, s, s), jnp.float32)
    tf = tf.at[:, :bl, :bl, :bl].set(t_own)
    wf = wf.at[:, :bl, :bl, :bl].set(w_own)

    # paste the +neighbor boundary slabs; d = (dx, dy, dz)
    for d in ((1, 0, 0), (0, 1, 0), (0, 0, 1),
              (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1)):
        ncoord = block_pos + jnp.asarray(d, jnp.int32)
        npool = h.lookup(vol, ncoord)
        nhit = mask & (npool >= 0)
        t_n, w_n = rows_of(npool, nhit)
        dx, dy, dz = d
        # source: the neighbor's 0-plane(s) along each offset axis;
        # destination: the field's bl-index along those axes
        sx = slice(0, 1) if dx else slice(0, bl)
        sy = slice(0, 1) if dy else slice(0, bl)
        sz = slice(0, 1) if dz else slice(0, bl)
        ddx = slice(bl, s) if dx else slice(0, bl)
        ddy = slice(bl, s) if dy else slice(0, bl)
        ddz = slice(bl, s) if dz else slice(0, bl)
        tf = tf.at[:, ddz, ddy, ddx].set(t_n[:, sz, sy, sx])
        wf = wf.at[:, ddz, ddy, ddx].set(w_n[:, sz, sy, sx])

    # observed = carries fused data: weight > 0 OR tsdf moved off the
    # reset/default value (far-depth fusion rounds weight to 0 while
    # still writing tsdf, voxel_tsdf.cu:182,192)
    obs = (wf > 0) | (jnp.abs(tf) < 0.999)
    return tf, obs


def _extract_from_blocks(
    vol: TSDFVolume,
    block_pos: jnp.ndarray,  # [V, 3]
    pool_idx: jnp.ndarray,  # [V]
    mask: jnp.ndarray,  # [V]
    max_tris: int,
) -> Mesh:
    cfg = vol.cfg
    vcap = block_pos.shape[0]
    bl = cfg.block_len

    tf, obs = _block_fields(vol, block_pos, pool_idx, mask)

    # per-corner slabs: corner c = (dx, dy, dz) -> field[z+dz, y+dy, x+dx]
    # as a static slice, flattened to the in-block cell order x + 8y + 64z
    f8, o8 = [], []
    for (dx, dy, dz) in _CORNER_OFFSETS:
        f8.append(tf[:, dz:dz + bl, dy:dy + bl, dx:dx + bl].reshape(vcap, -1))
        o8.append(obs[:, dz:dz + bl, dy:dy + bl, dx:dx + bl].reshape(vcap, -1))
    vcount = vcap * (bl ** 3)
    fv_all = jnp.stack([a.reshape(-1) for a in f8], axis=1)  # [N, 8]
    okv_all = mask.repeat(bl ** 3) & jnp.all(
        jnp.stack([a.reshape(-1) for a in o8], axis=1), axis=1)

    # --- cell compaction: only cells with mixed corner signs emit
    # triangles (~5% at the bench workload), so the 12-pass tetrahedra
    # pipeline below runs over the compacted set only.  Capacity max_tris//2 cells (a producing cell
    # emits >= 2 tris on average); overflow cells drop exactly like the
    # triangle-capacity drop below.
    cell_cap = max(256, max_tris // 2)
    cand = okv_all & (jnp.min(fv_all, axis=1) < 0) & (jnp.max(fv_all, axis=1) >= 0)
    crank = jnp.cumsum(cand.astype(jnp.int32)) - 1
    cslot = jnp.where(cand & (crank < cell_cap), crank, cell_cap)
    cids = (
        jnp.full((cell_cap,), vcount, jnp.int32)
        .at[cslot]
        .set(jnp.arange(vcount, dtype=jnp.int32), mode="drop")
    )
    kept = cids < vcount
    cids_safe = jnp.clip(cids, 0, vcount - 1)
    fv = fv_all[cids_safe]  # [C, 8]
    okv = kept  # compacted cells are observed+masked by construction

    # world positions of cell corners: base + cell offset + corner offset
    base = vx.block_to_point(block_pos, cfg)  # [V, 3]
    blk_of = cids_safe >> (3 * cfg.block_len_log2)
    coffc = vx.index_to_offset(
        cids_safe & (bl ** 3 - 1), cfg)  # [C, 3] (x, y, z)
    cell0 = (base[blk_of] + coffc).astype(jnp.float32) * cfg.voxel_size
    vsz = cfg.voxel_size
    corner_pos = [
        cell0 + jnp.asarray([dx * vsz, dy * vsz, dz * vsz], jnp.float32)
        for (dx, dy, dz) in _CORNER_OFFSETS
    ]  # 8 x [C, 3]

    tri_vs = []
    tri_valid = []
    for t in range(6):
        corners = [int(c) for c in _TETS[t]]
        ft = jnp.stack([fv[:, c] for c in corners], axis=1)  # [N, 4]
        pt = jnp.stack([corner_pos[c] for c in corners], axis=1)  # [N, 4, 3]
        case = (
            (ft[:, 0] < 0).astype(jnp.int32)
            | ((ft[:, 1] < 0).astype(jnp.int32) << 1)
            | ((ft[:, 2] < 0).astype(jnp.int32) << 2)
            | ((ft[:, 3] < 0).astype(jnp.int32) << 3)
        )
        # interpolated vertex on each of the 6 tet edges (static stacks,
        # not index gathers)
        fa = jnp.stack([ft[:, int(a)] for a, _ in _TET_EDGES], 1)  # [N, 6]
        fb = jnp.stack([ft[:, int(b)] for _, b in _TET_EDGES], 1)
        pa = jnp.stack([pt[:, int(a)] for a, _ in _TET_EDGES], 1)  # [N, 6, 3]
        pb = jnp.stack([pt[:, int(b)] for _, b in _TET_EDGES], 1)
        denom = fa - fb
        alpha = jnp.where(jnp.abs(denom) > 1e-12, fa / jnp.where(denom == 0, 1.0, denom), 0.5)
        alpha = jnp.clip(alpha, 0.0, 1.0)
        everts = pa + alpha[..., None] * (pb - pa)  # [N, 6, 3]

        # outward direction: from the centroid of inside (tsdf < 0)
        # corners toward the centroid of outside corners; used to orient
        # each emitted triangle (the 6 cube tets have mixed parity, so
        # windings are fixed geometrically rather than via the table)
        neg = (ft < 0).astype(jnp.float32)  # [N, 4]
        pos = 1.0 - neg
        n_neg = jnp.maximum(neg.sum(-1, keepdims=True), 1.0)
        n_pos = jnp.maximum(pos.sum(-1, keepdims=True), 1.0)
        cent_neg = jnp.sum(pt * neg[..., None], axis=1) / n_neg
        cent_pos = jnp.sum(pt * pos[..., None], axis=1) / n_pos
        outward = cent_pos - cent_neg  # [N, 3]

        for k in range(2):
            # table lookup by 16-case arithmetic select (no gathers):
            # edge ids for this (case, k) slot, then vertex select over
            # the 6 edge verts — each an exact one-term sum
            tk0 = jnp.zeros_like(case) - 1
            tk1 = jnp.zeros_like(case) - 1
            tk2 = jnp.zeros_like(case) - 1
            for c in range(16):
                e0, e1, e2 = (int(x) for x in _TET_TABLE[c, k])
                hitc = case == c
                tk0 = jnp.where(hitc, e0, tk0)
                tk1 = jnp.where(hitc, e1, tk1)
                tk2 = jnp.where(hitc, e2, tk2)
            valid = okv & (tk0 >= 0)
            v3_parts = []
            for tke in (tk0, tk1, tk2):
                acc = jnp.zeros((everts.shape[0], 3), jnp.float32)
                for e in range(6):
                    acc = jnp.where(
                        (tke == e)[:, None], everts[:, e], acc)
                v3_parts.append(acc)
            v3 = jnp.stack(v3_parts, axis=1)  # [N, 3, 3]
            nrm = jnp.cross(v3[:, 1] - v3[:, 0], v3[:, 2] - v3[:, 0])
            flip = jnp.sum(nrm * outward, axis=-1) < 0
            v3 = jnp.where(flip[:, None, None], v3[:, [0, 2, 1]], v3)
            tri_vs.append(v3)
            tri_valid.append(valid)

    all_tris = jnp.concatenate(tri_vs, axis=0)  # [12*N, 3, 3]
    all_valid = jnp.concatenate(tri_valid, axis=0)

    # compact into the fixed-capacity output
    rank = jnp.cumsum(all_valid.astype(jnp.int32)) - 1
    slot = jnp.where(all_valid & (rank < max_tris), rank, max_tris)
    out = jnp.zeros((max_tris, 3, 3), jnp.float32).at[slot].set(all_tris, mode="drop")
    count = jnp.minimum(jnp.sum(all_valid.astype(jnp.int32)), max_tris)
    valid = jnp.arange(max_tris) < count
    return Mesh(vertices=out, valid=valid, count=count)


def compact_mesh(mesh: Mesh) -> np.ndarray:
    """Host-side: [count, 3, 3] float32 triangle array.  Slices on
    device first so only real rows cross the (bandwidth-limited)
    device->host link."""
    n = int(mesh.count)
    return np.asarray(mesh.vertices[:n])


def merge_vertices(tris: np.ndarray, tol: float = 1e-5):
    """Triangle soup -> indexed mesh (vertices, faces) by welding
    coincident vertices (the MergeVertices(mesh, eps) step of
    ros_interface.cpp:103)."""
    flat = tris.reshape(-1, 3)
    key = np.round(flat / tol).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    verts = np.zeros((len(uniq), 3), np.float64)
    counts = np.zeros(len(uniq), np.int64)
    np.add.at(verts, inv, flat)
    np.add.at(counts, inv, 1)
    verts /= np.maximum(counts[:, None], 1)
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[good]


def vertex_attributes(vol: TSDFVolume, verts: np.ndarray):
    """Sample (rgb u8 [N, 3], ht probability f32 [N]) at mesh vertices."""
    pts = jnp.asarray(
        np.round(verts / vol.cfg.voxel_size).astype(np.int32)
    )
    _, rgb, _, prob = h.read_voxels(vol, pts)
    return (
        np.clip(np.asarray(rgb), 0, 255).astype(np.uint8),
        np.asarray(prob, np.float32),
    )


def save_ply(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    rgb: np.ndarray | None = None,
    prob: np.ndarray | None = None,
) -> None:
    """Write a PLY mesh, optionally with per-vertex color and the
    high-touch probability as a custom scalar — the semantic mesh output
    the reference's geometry-only pipeline cannot produce."""
    has_color = rgb is not None
    has_prob = prob is not None
    with open(path, "wb") as fp:
        head = ["ply", "format binary_little_endian 1.0",
                f"element vertex {len(verts)}",
                "property float x", "property float y", "property float z"]
        if has_color:
            head += ["property uchar red", "property uchar green",
                     "property uchar blue"]
        if has_prob:
            head += ["property float ht_probability"]
        head += [f"element face {len(faces)}",
                 "property list uchar int vertex_indices", "end_header"]
        fp.write(("\n".join(head) + "\n").encode())
        for i in range(len(verts)):
            fp.write(np.asarray(verts[i], "<f4").tobytes())
            if has_color:
                fp.write(np.asarray(rgb[i], np.uint8).tobytes())
            if has_prob:
                fp.write(np.asarray(prob[i], "<f4").tobytes())
        for f in faces:
            fp.write(np.uint8(3).tobytes())
            fp.write(np.asarray(f, "<i4").tobytes())


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write a Wavefront OBJ (the portable stand-in for the reference's
    shape_msgs/Mesh publication)."""
    with open(path, "w") as fp:
        for v in verts:
            fp.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in faces + 1:
            fp.write(f"f {f[0]} {f[1]} {f[2]}\n")
