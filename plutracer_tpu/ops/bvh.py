"""BVH: host-side builder + flattened arrays + iterative device traversal.

The reference builds a binary tree by recursive median split on primitive
centroids, cycling the split axis x->y->z, leaves holding one primitive and
the 2-element case special-cased (src/surfaces/bvh_tree.cpp:7-36); traversal
tests the node AABB and always visits both children, nearest t wins
(bvh_tree.cpp:39-76).

Array-first redesign: the tree is flattened to arrays in depth-first order
with skip links, and traversal is an iterative `lax.while_loop` per ray
batch over those arrays — no recursion, no pointers:

- hit the node's AABB -> advance to node+1 (first child);
- miss (or consumed a leaf) -> jump to the node's `skip` index (the next
  subtree in DFS order);
- leaves intersect their primitive branchlessly and fold into a running
  (t, prim) minimum.

The AABB test is the reference's slab test (inc/cmmn.h:150-170): hit iff
tmax >= tmin, with NO positivity or t-range check — reference-faithful
(an AABB fully behind the ray still "hits", costing traversal but not
correctness). Leaf order is exactly the reference's topology, so closest-hit
results are bit-identical to brute force (same winner under ties because
DFS leaf order preserves the sorted-median recursion's primitive order and
argmin tie-breaks don't arise: strict `<` on t).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from plutracer_tpu.scene.types import PRIM_BOX, PRIM_SPHERE, PRIM_TRIANGLE


# ---------------------------------------------------------------------------
# host-side build
# ---------------------------------------------------------------------------


def prim_bounds(ptype: int, a, b, c) -> Tuple[np.ndarray, np.ndarray]:
    """AABB per primitive (sphere.h:12-14, box.h:11-13, triangle.h:21-24)."""
    if ptype == PRIM_SPHERE:
        r = b[0]
        return a - r, a + r
    if ptype == PRIM_BOX:
        return a.copy(), b.copy()
    lo = np.minimum(np.minimum(a, b), c)
    hi = np.maximum(np.maximum(a, b), c)
    return lo, hi


@dataclasses.dataclass
class BvhArrays:
    """Flattened DFS tree. N nodes; leaves reference primitive rows."""

    node_min: Any  # (N,3) f32
    node_max: Any  # (N,3) f32
    node_skip: Any  # (N,) i32: next node in DFS order skipping this subtree
    node_prim: Any  # (N,) i32: primitive row at a leaf, else -1

    @property
    def num_nodes(self) -> int:
        return self.node_skip.shape[0]


_BVH_FIELDS = ("node_min", "node_max", "node_skip", "node_prim")
jax.tree_util.register_pytree_node(
    BvhArrays,
    lambda b: (tuple(getattr(b, f) for f in _BVH_FIELDS), None),
    lambda _, ch: BvhArrays(**dict(zip(_BVH_FIELDS, ch))),
)


def build_bvh(scene_np, use_native: bool = True) -> BvhArrays:
    """Build from host-side primitive arrays (numpy views of SceneArrays).

    Median-split on bounds centers, axis cycling x->y->z, matching the
    reference topology (bvh_tree.cpp:7-36): size-1 -> leaf; size-2 -> two
    leaf children (no sort!); else sort by center[axis], split at n//2.

    Prefers the native C++ builder (native/bvh_builder.cpp) — same
    topology, ~100x faster for triangle meshes; this Python path is the
    semantic oracle and the fallback.
    """
    if use_native and scene_np.prim_type.shape[0] > 1:
        from plutracer_tpu import native as _native

        prims10 = np.concatenate(
            [
                np.asarray(scene_np.prim_type, np.float32)[:, None],
                np.asarray(scene_np.prim_a, np.float32),
                np.asarray(scene_np.prim_b, np.float32),
                np.asarray(scene_np.prim_c, np.float32),
            ],
            axis=1,
        )
        out = _native.build_bvh_native(prims10)
        if out is not None:
            mn, mx, skip, prim = out
            # host numpy; compile_scene device_puts the whole scene pytree
            return BvhArrays(
                node_min=np.asarray(mn, np.float32),
                node_max=np.asarray(mx, np.float32),
                node_skip=np.asarray(skip, np.int32),
                node_prim=np.asarray(prim, np.int32),
            )

    ptype = np.asarray(scene_np.prim_type)
    pa = np.asarray(scene_np.prim_a)
    pb = np.asarray(scene_np.prim_b)
    pc = np.asarray(scene_np.prim_c)
    P = ptype.shape[0]

    lo = np.zeros((P, 3), np.float32)
    hi = np.zeros((P, 3), np.float32)
    for i in range(P):
        lo[i], hi[i] = prim_bounds(int(ptype[i]), pa[i], pb[i], pc[i])
    centers = (lo + hi) * 0.5

    node_min: List[np.ndarray] = []
    node_max: List[np.ndarray] = []
    node_prim: List[int] = []
    children: List[Tuple[int, int]] = []  # (left, right) or (-1,-1) for leaf

    def add_node(mn, mx, prim=-1):
        node_min.append(mn)
        node_max.append(mx)
        node_prim.append(prim)
        children.append((-1, -1))
        return len(node_prim) - 1

    def build(idx: np.ndarray, axis: int) -> int:
        if len(idx) == 1:
            i = int(idx[0])
            return add_node(lo[i], hi[i], i)
        if len(idx) == 2:
            # reference special-cases 2 without sorting (bvh_tree.cpp:22-26)
            l = build(idx[:1], axis)
            r = build(idx[1:], axis)
            mn = np.minimum(node_min[l], node_min[r])
            mx = np.maximum(node_max[l], node_max[r])
            n = add_node(mn, mx)
            children[n] = (l, r)
            return n
        order = np.argsort(centers[idx, axis], kind="stable")
        idx = idx[order]
        mid = len(idx) // 2
        nxt = (axis + 1) % 3
        l = build(idx[:mid], nxt)
        r = build(idx[mid:], nxt)
        mn = np.minimum(node_min[l], node_min[r])
        mx = np.maximum(node_max[l], node_max[r])
        n = add_node(mn, mx)
        children[n] = (l, r)
        return n

    root = build(np.arange(P), 0)

    # re-number into DFS (pre-order) layout with skip links
    N = len(node_prim)
    dfs_min = np.zeros((N, 3), np.float32)
    dfs_max = np.zeros((N, 3), np.float32)
    dfs_skip = np.zeros(N, np.int32)
    dfs_prim = np.full(N, -1, np.int32)
    counter = [0]
    size_cache = {}

    def subtree_size(n: int) -> int:
        if n not in size_cache:
            l, r = children[n]
            size_cache[n] = 1 if l < 0 else 1 + subtree_size(l) + subtree_size(r)
        return size_cache[n]

    def layout(n: int) -> None:
        me = counter[0]
        counter[0] += 1
        dfs_min[me] = node_min[n]
        dfs_max[me] = node_max[n]
        # skip = first node after my whole subtree in pre-order
        dfs_skip[me] = me + subtree_size(n)
        l, r = children[n]
        if l < 0:
            dfs_prim[me] = node_prim[n]
        else:
            layout(l)
            layout(r)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * N + 100))
    try:
        layout(root)
    finally:
        sys.setrecursionlimit(old_limit)

    return BvhArrays(
        node_min=dfs_min,
        node_max=dfs_max,
        node_skip=dfs_skip,
        node_prim=dfs_prim,
    )


def parent_bounds_tables(bvh: BvhArrays, prim_count: int):
    """Per-primitive PARENT-node AABB for phantom-hit culling.

    Reference semantics (src/surfaces/bvh_tree.cpp:39-76): a leaf's
    primitive is only tested when every internal node on the root->leaf
    path passed the slab LINE test aabb::hit (inc/cmmn.h:150-172, `tmax >=
    tmin`, no positivity); the leaf's OWN aabb is never tested
    (bvh_node::hit returns object->hit directly for leaves). Internal-node
    bounds are unions of their children (bvh_tree.cpp:7-36), so the chain
    is NESTED: parent box <= every higher ancestor box — and a line that
    intersects a set contained in X intersects X. The whole root->leaf
    conjunction therefore collapses EXACTLY to one test: the leaf's
    immediate parent's AABB.

    Why this is visible behavior, not a perf detail: the reference's
    shading frames go degenerate on x-face boxes (S == +-N, T == 0;
    box.cpp:29-33 dpdu) and skewed on off-axis spheres (dpdu not tangent),
    producing NON-UNIT sampled directions — and sphere::hit's quadratic
    assumes |d| == 1 (sphere.cpp:17-21), so non-unit rays yield PHANTOM
    hits at points off the sphere. The reference's internal-node culling
    silently discards exactly the phantoms whose ray line misses the
    subtree unions, while a plain brute-force intersector keeps them.
    (Found in round 4: without this cull our cornell bounce>=2 radiance ran
    1.5-2x hot — phantom wall->sphere->light caustics the reference never
    traces.)

    True hits always lie inside their primitive's AABB and therefore inside
    the parent union, so culling NEVER changes a box/triangle result (their
    predicates are exact for any |d|); only sphere rows can differ.

    Returns (parent_min (P,3), parent_max (P,3)) numpy f32; primitives
    with no internal parent (single-primitive scene) get an always-hit
    +-3e38 dummy box.
    """
    node_prim = np.asarray(bvh.node_prim)
    node_skip = np.asarray(bvh.node_skip)
    node_mn = np.asarray(bvh.node_min)
    node_mx = np.asarray(bvh.node_max)
    N = node_prim.shape[0]

    pmin = np.full((prim_count, 3), -3.0e38, np.float32)
    pmax = np.full((prim_count, 3), 3.0e38, np.float32)
    # pre-order: ancestors of node l = internal n < l with skip[n] > l;
    # the stack top when visiting a leaf is its immediate parent
    stack: List[int] = []
    for n in range(N):
        while stack and node_skip[stack[-1]] <= n:
            stack.pop()
        p = int(node_prim[n])
        if p >= 0:
            if stack:
                a = stack[-1]
                pmin[p] = node_mn[a]
                pmax[p] = node_mx[a]
        else:
            stack.append(n)
    return pmin, pmax


# ---------------------------------------------------------------------------
# device traversal
# ---------------------------------------------------------------------------


def _aabb_hit(o, d, mn, mx):
    """Reference slab test (inc/cmmn.h:150-170): hit iff tmax >= tmin.
    Delegates to the math-core Aabb (ops/geometry.py)."""
    from plutracer_tpu.ops.geometry import Aabb

    return Aabb(mn, mx).hit(o, d)


def bvh_closest(scene, bvh: BvhArrays, o, d):
    """Closest-hit via skip-link traversal. Returns (found, prim, t).

    All rays advance in lockstep through their own node pointers; dead rays
    (pointer == N) idle until the last ray finishes. Wavefront-friendly: no
    stack, 2 int32s of state per ray.
    """
    from plutracer_tpu.ops.intersect import T_MAX, _BIG, _prim_t_batched

    B = o.shape[0]
    N = bvh.num_nodes
    # build_bvh returns host numpy (compile_scene device_puts the whole
    # pytree in one shot); coerce here so standalone callers can traverse
    # a fresh tree directly — tracer-indexing a numpy array is an error
    bvh = BvhArrays(
        node_min=jnp.asarray(bvh.node_min),
        node_max=jnp.asarray(bvh.node_max),
        node_skip=jnp.asarray(bvh.node_skip),
        node_prim=jnp.asarray(bvh.node_prim),
    )

    def cond(state):
        node, best_t, best_p = state
        return jnp.any(node < N)

    def step(state):
        node, best_t, best_p = state
        active = node < N
        ni = jnp.minimum(node, N - 1)
        mn = bvh.node_min[ni]
        mx = bvh.node_max[ni]
        hit_box = _aabb_hit(o, d, mn, mx) & active
        prim = bvh.node_prim[ni]
        is_leaf = prim >= 0

        # leaf: intersect its primitive (branchless, masked)
        pi = jnp.maximum(prim, 0)
        t = _prim_t_batched(
            o,
            d,
            scene.prim_type[pi],
            scene.prim_a[pi],
            scene.prim_b[pi],
            scene.prim_c[pi],
        )
        # reference leaves are tested WITHOUT their own aabb check
        # (bvh_node::hit returns object->hit directly, bvh_tree.cpp:40-42);
        # only internal nodes cull. This is visible behavior for phantom
        # sphere hits of non-unit rays — see ancestor_tables.
        take = active & is_leaf & (t < best_t)
        best_t = jnp.where(take, t, best_t)
        best_p = jnp.where(take, pi, best_p)

        # advance: into the subtree on AABB hit (internal), else skip
        descend = hit_box & ~is_leaf
        node = jnp.where(active, jnp.where(descend, node + 1, bvh.node_skip[ni]), node)
        return node, best_t, best_p

    node0 = jnp.zeros((B,), jnp.int32)
    best_t0 = jnp.full((B,), _BIG)
    best_p0 = jnp.zeros((B,), jnp.int32)
    node, best_t, best_p = jax.lax.while_loop(cond, step, (node0, best_t0, best_p0))
    found = best_t < T_MAX
    return found, best_p, best_t
