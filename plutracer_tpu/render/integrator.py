"""Path-tracing integrator: next-event estimation + MIS, fixed-depth scan.

Faithful to renderer::ray_color / estimate_direct_light /
uniform_sample_one_light (src/renderer.cpp:5-96):

- shading vertices at bounces 0..7 (break when `bounces > 6` fires after the
  8th vertex's throughput update), no Russian roulette;
- emitted radiance added only at the first vertex or after a specular bounce;
- one uniformly-chosen light per vertex, estimator scaled by light count;
- light-strategy MIS weight uses the (reference-swapped) power heuristic
  bsdf^2/(bsdf^2+light^2) — RenderOptions.swapped_light_mis_weight;
- the BSDF-strategy's emitted radiance is gated on the *shading* normal
  (RenderOptions.shading_normal_le_gate);
- escaped rays contribute nothing: every reference light type inherits
  light::Le(ray) == 0 (inc/light.h:10), so the `spec_bounce` escape sum
  (renderer.cpp:86-90) is identically zero and is omitted here;
- point lights are occluded by ANY hit along the shadow ray, even beyond
  the light itself (renderer.cpp:16-17 traces to t_max) — replicated.

Execution shape: `lax.scan` over megabatches with an alive mask; discrete
material/light choices are masked selects. Each bounce issues ONE batched
closest-hit query over 3B rays (shadow + NEE-BSDF + extension, all
originating at the shading point); the extension hit is carried into the
next iteration. All entity lookups go through packed-row gathers
(ops.tables) — one gather per table per bounce instead of one per field.
RNG is counter-based: one key per batch, folded with the bounce index.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from plutracer_tpu.ops import bsdf as bsdf_ops
from plutracer_tpu.ops import intersect, lights, safemath
from plutracer_tpu.ops.tables import (
    gather_light,
    gather_mat,
    gather_prim,
    gather_prim_light,
    gather_tex,
    pack_tables,
)
from plutracer_tpu.ops.texture import eval_color_rows
from plutracer_tpu.semantics import DEFAULT_OPTIONS, RenderOptions


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _nee_contributions(
    hit, frame, mtype, albedo, wwo, options, ls, bs, lrows, carrier,
    shadow_found, shadow_hits_light, nee_found, nee_hits_light, nee_norm,
):
    """Assemble estimate_direct_light (renderer.cpp:5-51) once visibility
    results for the shadow ray and the BSDF-strategy ray are known."""
    p = hit.p
    n = hit.norm

    # Finite-by-construction weight math: every pdf entering ARITHMETIC is
    # clipped to [1e-12, 1e9] (gates keep the raw values). Raw area-light
    # pdfs reach ~1e22 at grazing carrier angles; squaring them overflows
    # f32 to inf, and 1/pdf of a denormal does too. The primal outcomes
    # are unchanged to f32 precision (both raw and clipped forms drive
    # the weight or the contribution to 0/1 at the extremes), but inf
    # NEVER materializes — an inf residual saved by the bounce scan makes
    # the whole reverse pass NaN via 0 * inf even on fully-masked lanes
    # (before the clamp, ~40-50% of train steps at max_bounces=8 lost
    # their entire mat_color gradient to this).
    clipp = lambda x: jnp.clip(x, 1e-12, 1e9)

    # ---- light-sampling strategy ----
    f = bsdf_ops.bsdf_F_nee(mtype, albedo, n, wwo, ls.wi)
    unoccl = ~shadow_found | (~ls.is_delta & shadow_hits_light)
    b_pdf = bsdf_ops.bsdf_pdf_nee(frame, mtype, wwo, ls.wi)
    # safe_div in the MIS ratios: the denominator can sit at ~2e-24
    # (both pdfs at the clip floor) whose square flushes to 0 in the
    # plain div transpose -> 0/0 NaN (ops/safemath.py)
    bp = clipp(b_pdf)
    lp = clipp(ls.pdf)
    if options.swapped_light_mis_weight:
        w = safemath.safe_div(bp * bp, bp * bp + lp * lp)
    else:
        w = safemath.safe_div(lp * lp, bp * bp + lp * lp)
    # the clip floor makes the denominator nonzero, but keep the
    # historical zero-weight outcome when BOTH raw pdfs are zero
    w = jnp.where((b_pdf == 0.0) & (ls.pdf == 0.0), 0.0, w)
    w = jnp.where(ls.is_delta, 1.0, w)
    gate_l = (
        (ls.pdf > 0.0)
        & (_dot(ls.Li, ls.Li) > 0.0)
        & (_dot(f, f) > 0.0)
        & unoccl
    )
    scale_l = jnp.where(
        gate_l, safemath.safe_div(jnp.abs(_dot(ls.wi, n)) * w, lp), 0.0
    )
    contrib_l = f * ls.Li * scale_l[..., None]
    contrib_l = jnp.where(gate_l[..., None], contrib_l, 0.0)

    # ---- BSDF-sampling strategy (non-delta lights only) ----
    l_pdf2 = lights.light_pdf_rows(lrows, carrier, p, bs.wwi, options)
    bp2 = clipp(bs.pdf)
    lp2 = clipp(l_pdf2)
    w2 = safemath.safe_div(bp2 * bp2, bp2 * bp2 + lp2 * lp2)
    w2 = jnp.where((bs.pdf == 0.0) & (l_pdf2 == 0.0), 0.0, w2)
    w2 = jnp.where(bs.is_specular, 1.0, w2)
    if options.shading_normal_le_gate:
        # reference passes the SHADING point's (p, n) into material::Le
        # (renderer.cpp:42): emission gated on dot(n_shading, -wi) > 0
        le_gate = _dot(n, -bs.wwi) > 0.0
    else:
        le_gate = _dot(nee_norm, -bs.wwi) > 0.0
    same_light = nee_found & nee_hits_light
    Li2 = jnp.where((same_light & le_gate)[..., None], lrows.intensity, 0.0)
    gate_b = (
        ~ls.is_delta
        & (_dot(bs.f, bs.f) > 0.0)
        & (bs.pdf > 0.0)
        & (bs.is_specular | (l_pdf2 != 0.0))  # early return when light_pdf==0
        & nee_found
        & (_dot(Li2, Li2) > 0.0)
    )
    scale_b = jnp.where(
        gate_b, safemath.safe_div(jnp.abs(_dot(bs.wwi, n)) * w2, bp2), 0.0
    )
    contrib_b = bs.f * Li2 * scale_b[..., None]
    contrib_b = jnp.where(gate_b[..., None], contrib_b, 0.0)
    return contrib_l, contrib_b


def estimate_direct(scene, hit, frame, mtype, albedo, wwo, li, u, options):
    """Standalone estimate_direct_light (kept for tests/tools; ray_color
    uses the batched-query path below). `u`: (B, 8) uniforms."""
    tables = pack_tables(scene)
    lrows = gather_light(tables, li)
    carrier = gather_prim(tables, jnp.maximum(lrows.prim, 0))
    ls = lights.sample_light_rows(
        lrows, carrier, hit.p, u[:, 0:2], u[:, 2], u[:, 3], options
    )
    mat = gather_prim(tables, hit.prim).material
    mrows = gather_mat(tables, mat)
    bs = bsdf_ops.bsdf_sample(
        frame, mtype, albedo, mrows.eta, mrows.k,
        wwo, u[:, 4], u[:, 5:7], non_specular_only=True,
    )
    sf, sp, _ = intersect.query_lite(scene, hit.p, ls.wi, options)
    nf, npr, nt = intersect.query_lite(scene, hit.p, bs.wwi, options)
    s_hits = gather_prim(tables, sp).light == li
    n_hits = gather_prim(tables, npr).light == li
    if options.shading_normal_le_gate:
        nn = hit.norm
    else:
        nn = intersect.hit_detail(scene, hit.p, bs.wwi, nt, npr, nf).norm
    cl, cb = _nee_contributions(
        hit, frame, mtype, albedo, wwo, options, ls, bs, lrows, carrier,
        sf, s_hits, nf, n_hits, nn,
    )
    return cl + cb


def ray_color(
    scene,
    o,
    d,
    key,
    options: RenderOptions = DEFAULT_OPTIONS,
    terms: bool = False,
):
    """Radiance for a batch of primary rays. o, d: (B,3). Returns (B,3).

    With terms=True (diagnostics — tools/term_dump.py)
    additionally returns a (max_bounces, 3, B, 3) per-bounce split of the
    radiance by contribution site, mirroring the instrumented reference
    build (tools/refbuild/build_dump.sh): term 0 = emitted-at-vertex
    (renderer.cpp:66), 1 = NEE light strategy, 2 = NEE BSDF strategy
    (renderer.cpp:5-51). sum(terms) == the returned L exactly.
    """
    B = o.shape[0]
    num_lights = scene.light_type.shape[0]
    tables = pack_tables(scene)
    has_images = scene.atlas.shape[0] > 1
    diff_t = intersect._resolve_backend(options) != "xla"

    # primary hit (reference traces it before entering the bounce loop,
    # renderer.cpp:61); subsequent hits ride the batched per-bounce query
    found0, prim0, t0 = intersect.query_lite(scene, o, d, options)
    if diff_t:
        rows0 = gather_prim(tables, prim0)
        t0d = intersect.prim_t_rows(o, d, rows0)
        # accept the differentiable recompute ONLY when it agrees the ray
        # hits: on knife-edge lanes the kernel's winner and the XLA accept
        # rules can disagree, and taking the recompute's _BIG sentinel
        # onto a found=True lane puts p at ~4e37 — whose downstream dot
        # products overflow to inf and NaN the whole backward
        t0 = jnp.where(found0 & (t0d < intersect.T_MAX), t0d, t0)

    def body(carry, i):
        o, d, T, L, prev_spec, alive, found, prim, t = carry
        k = jax.random.fold_in(key, i)
        u = jax.random.uniform(k, (B, 12))

        rows = gather_prim(tables, prim)
        hit = intersect.hit_detail_rows(o, d, t, prim, found, rows)
        cur = alive & hit.found
        wwo = -d
        mrows = gather_mat(tables, rows.material)
        mtype = mrows.mtype
        trows = gather_tex(tables, jnp.maximum(mrows.tex, 0))
        albedo = eval_color_rows(scene.atlas, mrows, trows, hit.uv, has_images)
        frame = bsdf_ops.make_frame(hit.norm, hit.dpdu)

        # emitted light at the vertex (first or post-specular only)
        emit_gate = (i == 0) | prev_spec
        own_light = gather_light(tables, jnp.maximum(rows.light, 0))
        Le = lights.emitted_rows(rows, own_light, hit.norm, wwo)
        t_emit = jnp.where((cur & emit_gate)[..., None], T * Le, 0.0)
        L = L + t_emit

        # next-event estimation: pick one light uniformly
        li = jnp.minimum(
            jnp.floor(u[:, 0] * num_lights).astype(jnp.int32), num_lights - 1
        )
        lrows = gather_light(tables, li)
        carrier = gather_prim(tables, jnp.maximum(lrows.prim, 0))
        ls = lights.sample_light_rows(
            lrows, carrier, hit.p, u[:, 1:3], u[:, 3], u[:, 4], options
        )
        bs_nee = bsdf_ops.bsdf_sample(
            frame, mtype, albedo, mrows.eta, mrows.k, wwo, u[:, 5], u[:, 6:8],
            non_specular_only=True,
        )
        # main BSDF sample for the path extension
        bs = bsdf_ops.bsdf_sample(
            frame, mtype, albedo, mrows.eta, mrows.k, wwo, u[:, 9], u[:, 10:12]
        )

        # ONE batched closest-hit query: [shadow | nee-bsdf | extension]
        O3 = jnp.concatenate([hit.p, hit.p, hit.p], 0)
        D3 = jnp.concatenate([ls.wi, bs_nee.wwi, bs.wwi], 0)
        f3, p3, t3 = intersect.query_lite(scene, O3, D3, options)
        # one column lookup for the hit prims' light links (shadow + nee)
        plight3 = gather_prim_light(tables, p3[: 2 * B])
        sf, nf, xf = f3[:B], f3[B : 2 * B], f3[2 * B :]
        xp = p3[2 * B :]
        xt = t3[2 * B :]
        s_hits = plight3[:B] == li
        n_hits = plight3[B:] == li

        if options.shading_normal_le_gate:
            nee_norm = hit.norm  # unused in this mode
        else:
            nrows = gather_prim(tables, p3[B : 2 * B])
            nee_norm = intersect.hit_detail_rows(
                hit.p, bs_nee.wwi, t3[B : 2 * B], p3[B : 2 * B], nf, nrows
            ).norm
        cl, cb = _nee_contributions(
            hit, frame, mtype, albedo, wwo, options, ls, bs_nee, lrows, carrier,
            sf, s_hits, nf, n_hits, nee_norm,
        )
        t_nee_l = jnp.where(cur[..., None], T * cl * num_lights, 0.0)
        t_nee_b = jnp.where(cur[..., None], T * cb * num_lights, 0.0)
        L = L + t_nee_l + t_nee_b

        # throughput update + path termination. The per-bounce weight and
        # the running product are clamped (1e12 / 1e16): the reference's
        # degenerate x-face wall frames grow |cos|/pdf without bound, and
        # at max_bounces=8 the f32 product can overflow to inf on a LIVE
        # lane — the primal stays masked-finite but every term's backward
        # then dies of 0 * inf (before the clamp ~40% of train steps had
        # fully-NaN mat_color gradients). Radiance from a >=1e12-weight
        # path is saturated garbage in any output; the clamp is invisible
        # below it (semantics.py silent-guards).
        ok = (_dot(bs.f, bs.f) > 0.0) & (bs.pdf > 0.0)
        alive_next = cur & ok & (i <= options.max_bounces - 2)
        # clipped pdf (no inf from denormal reciprocals) + clamped weight
        # and product: see the finite-by-construction note in
        # _nee_contributions and the throughput note in semantics.py
        w_b = jnp.minimum(
            bs.f
            * safemath.safe_div(
                jnp.abs(_dot(bs.wwi, hit.norm)),
                jnp.clip(bs.pdf, 1e-12, 1e9),
            )[..., None],
            1.0e12,
        )
        T_next = jnp.minimum(T * w_b, 1.0e16)
        T = jnp.where(alive_next[..., None], T_next, T)

        # differentiable t recompute for non-AD backends (see query_closest;
        # _BIG-sentinel guard as at the primary hit above)
        if diff_t:
            xrows = gather_prim(tables, xp)
            xtd = intersect.prim_t_rows(hit.p, bs.wwi, xrows)
            xt = jnp.where(xf & (xtd < intersect.T_MAX), xtd, xt)
        ys = jnp.stack([t_emit, t_nee_l, t_nee_b], 0) if terms else None
        return (hit.p, bs.wwi, T, L, bs.is_specular, alive_next, xf, xp, xt), ys

    # derive carry inits from the (possibly shard_map-varying) ray inputs so
    # the scan carry has consistent varying-manual-axis types under shard_map
    zeros3 = jnp.zeros_like(o)
    init = (
        o,
        d,
        zeros3 + 1.0,
        zeros3,
        jnp.zeros_like(o[..., 0], dtype=bool),
        jnp.zeros_like(o[..., 0], dtype=bool) | True,
        found0,
        prim0,
        t0,
    )
    body_fn = body
    if getattr(options, "remat_bounces", False):
        # recompute-in-backward: see semantics.RenderOptions.remat_bounces
        body_fn = jax.checkpoint(body)
    carry, ys = jax.lax.scan(body_fn, init, jnp.arange(options.max_bounces))
    if terms:
        return carry[3], ys
    return carry[3]
