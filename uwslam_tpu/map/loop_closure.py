"""Loop-closure detection + pose-graph correction.

The reference has no loop closure (its Sim3 typedef at
/root/reference/include/Options.h:130 signals the intent, never realized;
SURVEY.md §5). This module supplies it as batched arrays:

- every keyframe leaves a lightweight record (pose, keypoints, descriptors,
  camera-frame 3D) — pyramids are NOT retained, so history is cheap;
- candidate retrieval is a single matmul against VLAD global descriptors
  (k-means vocabulary over the session's own keypoint descriptors, residual
  aggregation per visual word, intra+global L2 normalization) — far more
  discriminative than mean pooling (two rooms with similar texture
  statistics no longer collide) while retrieval stays one matmul;
  mean-pooling remains the cold-start fallback until enough descriptors
  accumulate to train the vocabulary;
- verification is descriptor matching + PnP RANSAC (features.pnp), giving a
  metric relative-pose constraint;
- accepted loops trigger pose-graph LM (ba.pose_graph) over the whole
  keyframe trajectory, with node/edge buffers padded to buckets so XLA
  recompiles only when the graph outgrows its bucket.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ba.pose_graph import (
    PoseGraph,
    Sim3PoseGraph,
    optimize_pose_graph,
    optimize_pose_graph_sim3,
)
from ..lie import se3, sim3


class KeyframeRecord(NamedTuple):
    frame_id: int
    T_wc: np.ndarray
    kp_uv: jax.Array
    kp_desc: jax.Array
    kp_valid: jax.Array
    kp_p3d: jax.Array
    global_desc: np.ndarray   # (D,) mean-pooled keypoint descriptor


class LoopEdge(NamedTuple):
    i: int          # history index of the older keyframe
    j: int          # history index of the newer keyframe
    T_ij: np.ndarray  # kf_i <- kf_j relative pose
    num_inliers: int
    # Relative monocular scale of kf_j's local map vs kf_i's gauge (the
    # median PnP-inlier depth ratio): >1 means j's map depths are inflated.
    # The Sim(3) pose graph absorbs exactly this drift — the capability the
    # reference's uw::Sim3 typedef (include/Options.h:130) intended.
    scale: float = 1.0


@dataclass
class LoopConfig:
    min_gap: int = 8              # keyframes between i and j to count as loop
    max_candidates: int = 3       # PnP-verified per new keyframe
    min_similarity: float = 0.70  # mean-pool cosine gate (cold start)
    # VLAD retrieval: visual-word count and how many descriptors must
    # accumulate before the vocabulary is trained (mean-pooling until then).
    # VLAD signatures are residual-based and much sparser in angle than
    # mean-pooled ones — true revisits land far lower on the cosine scale,
    # so the gate is separate.
    vocab_size: int = 16
    vocab_min_desc: int = 1024
    min_similarity_vlad: float = 0.25
    use_vlad: bool = True
    min_matches: int = 25
    # Wide-baseline revisit matching: the 0.65 consecutive-frame ratio
    # starves loop pairs exactly like it starved the global-BA keyframe
    # pairs (measured on the revisit eval: 32 -> 59 matches at 0.80; the
    # PnP-RANSAC verification right after keeps precision).
    match_ratio: float = 0.80
    # Verification threshold: keyframe keypoint 3D carries depth-prior
    # noise, and the revisit baseline amplifies it to several px of
    # reprojection error — at 3 px a TRUE revisit verified with 3-6
    # inliers (rejected); at 8 px with the same true pose it clears
    # pnp_min_inliers while the robust GN polish (soft MSAC weights)
    # keeps the edge pose anchored to the small-residual matches.
    pnp_threshold_px: float = 8.0
    pnp_min_inliers: int = 20
    # Loose-threshold safety gates (ADVICE r3): at 8 px a geometrically
    # consistent FALSE match set could clear pnp_min_inliers, and one bad
    # loop edge corrupts the whole trajectory through PGO. Two independent
    # signals must also pass:
    # 1. inlier ratio — false-candidate match sets verify (if at all) with
    #    a thin inlier fraction; true revisits keep most of their matches;
    min_inlier_ratio: float = 0.25
    # 2. reverse-PnP consistency — solve PnP both ways (cand 3D -> cur px
    #    and cur 3D -> cand px) and require the two relative poses to agree.
    #    A false correspondence set that fits one direction almost never
    #    fits its mirror image with a consistent pose.
    check_reverse_pnp: bool = True
    reverse_max_rot: float = 0.15          # rad
    reverse_max_trans_ratio: float = 0.35  # of |t| (+ 0.1 m absolute floor)
    # 3. reverse inlier FRACTION — adversarial finding (round-5 test
    #    TestAdversarialFalseLoops): a keyframe whose pixels fit a revisit
    #    pose but whose stored 3D is corrupted can still produce a
    #    pose-consistent reverse solve from a small lucky consensus
    #    (measured: 32/128 reverse inliers slipping under the composition
    #    gate). A true revisit re-verifies MOST of its forward inliers in
    #    the mirror direction; require that fraction.
    reverse_min_inlier_fraction: float = 0.3
    # 4. depth-ratio dispersion — the per-inlier z_pred/z_cur ratios of a
    #    true revisit scatter only by depth-prior noise (MAD of the log
    #    ratio ~0.1-0.2); corrupted or unrelated structure scatters wide.
    #    Applied when >= 8 ratio samples exist (same data the Sim(3) scale
    #    estimate uses).
    max_scale_log_mad: float = 0.35
    odometry_weight: float = 100.0
    loop_weight: float = 30.0
    max_pgo_iters: int = 30
    # Optimize the pose graph over Sim(3) (scale on loop edges estimated
    # from the PnP-inlier depth ratio) so accumulated monocular scale drift
    # is absorbed at closure; False falls back to SE(3) PGO.
    use_sim3: bool = True


def _bucket(n: int, size: int) -> int:
    return max(size, ((n + size - 1) // size) * size)


def _kmeans(X: np.ndarray, k: int, iters: int = 12, seed: int = 0) -> np.ndarray:
    """Plain Lloyd's with k-means++ seeding — the vocabulary trainer.

    Runs on host numpy: it fires ONCE per session over a few thousand
    D-dim descriptors (milliseconds), far off the per-frame hot path."""
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    # k-means++ init.
    centers = [X[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(
            ((X[:, None, :] - np.stack(centers)[None]) ** 2).sum(-1), axis=1
        )
        p = d2 / max(d2.sum(), 1e-12)
        centers.append(X[rng.choice(n, p=p)])
    C = np.stack(centers)
    for _ in range(iters):
        assign = np.argmin(
            ((X[:, None, :] - C[None]) ** 2).sum(-1), axis=1
        )
        for j in range(k):
            m = assign == j
            if m.any():
                C[j] = X[m].mean(axis=0)
    return C.astype(np.float32)


def _vlad(desc: np.ndarray, vocab: np.ndarray) -> np.ndarray:
    """VLAD aggregation: per-word residual sums, intra-normalized per word
    (power-law burstiness suppression) then globally L2-normalized.

    desc (N, D) valid descriptors; vocab (K, D). Returns (K*D,)."""
    K, D = vocab.shape
    if desc.shape[0] == 0:
        return np.zeros(K * D, np.float32)
    assign = np.argmin(
        ((desc[:, None, :] - vocab[None]) ** 2).sum(-1), axis=1
    )
    V = np.zeros((K, D), np.float32)
    np.add.at(V, assign, desc - vocab[assign])
    # Intra-normalization (per visual word) kills burstiness: one dominant
    # texture can't swamp the signature.
    norms = np.linalg.norm(V, axis=1, keepdims=True)
    V = V / np.maximum(norms, 1e-9)
    v = V.reshape(-1)
    return (v / max(float(np.linalg.norm(v)), 1e-9)).astype(np.float32)


@dataclass
class LoopCloser:
    """Keyframe history + loop detection + pose-graph optimization."""

    cam: "object"                 # PinholeCamera (host-held intrinsics)
    config: LoopConfig = field(default_factory=LoopConfig)
    history: list = field(default_factory=list)       # [KeyframeRecord]
    odo_rel: list = field(default_factory=list)       # [np (4,4)] i -> i+1
    loop_edges: list = field(default_factory=list)    # [LoopEdge]
    vocab: np.ndarray | None = None                   # (K, D) visual words

    def _global_desc(self, desc: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """VLAD signature once the vocabulary exists; mean-pool before."""
        d = desc[valid]
        if self.vocab is not None:
            return _vlad(d, self.vocab)
        g = d.mean(axis=0) if d.shape[0] else np.zeros(desc.shape[1])
        return (g / max(float(np.linalg.norm(g)), 1e-9)).astype(np.float32)

    def _maybe_train_vocab(self) -> None:
        """Train the k-means vocabulary from the session's own descriptors
        once enough have accumulated, then re-sign the whole history so all
        global descriptors live in the same (K*D) space."""
        cfg = self.config
        if self.vocab is not None or not cfg.use_vlad:
            return
        pools = [
            np.asarray(r.kp_desc, np.float32)[np.asarray(r.kp_valid)]
            for r in self.history
        ]
        total = sum(p.shape[0] for p in pools)
        if total < cfg.vocab_min_desc:
            return
        X = np.concatenate(pools, axis=0)
        # Cap the training set: k-means over ~4k points is plenty for K<=64.
        if X.shape[0] > 4096:
            sel = np.random.default_rng(0).choice(X.shape[0], 4096, False)
            X = X[sel]
        self.vocab = _kmeans(X, cfg.vocab_size)
        for k, r in enumerate(self.history):
            self.history[k] = r._replace(
                global_desc=self._global_desc(
                    np.asarray(r.kp_desc, np.float32), np.asarray(r.kp_valid)
                )
            )

    def add_keyframe(self, kf) -> None:
        """Record a keyframe (call after SlamSystem inserts it). kf must carry
        kp_desc/kp_valid/kp_p3d (features are attached by _make_keyframe)."""
        desc = np.asarray(kf.kp_desc, np.float32)
        valid = np.asarray(kf.kp_valid)
        g = self._global_desc(desc, valid)
        rec = KeyframeRecord(
            frame_id=kf.frame_id,
            T_wc=np.asarray(kf.T_wc, np.float32),
            kp_uv=kf.kp_uv,
            kp_desc=kf.kp_desc,
            kp_valid=kf.kp_valid,
            kp_p3d=kf.kp_p3d,
            global_desc=g.astype(np.float32),
        )
        if self.history:
            T_prev = self.history[-1].T_wc
            self.odo_rel.append(
                np.linalg.inv(T_prev) @ rec.T_wc  # prev <- new (world chain)
            )
        self.history.append(rec)
        self._maybe_train_vocab()

    # ------------------------------------------------------------- detection

    def detect(self, key=None) -> LoopEdge | None:
        """Try to close a loop for the LATEST keyframe. Returns the accepted
        edge (also appended to self.loop_edges) or None."""
        from ..features import match_descriptors, pnp_from_pixels

        cfg = self.config
        j = len(self.history) - 1
        if j < cfg.min_gap + 1:
            return None
        cur = self.history[j]
        past = self.history[: j - cfg.min_gap]
        G = np.stack([r.global_desc for r in past])       # (N, D)
        sims = G @ cur.global_desc                        # (N,)
        order = np.argsort(-sims)[: cfg.max_candidates]
        key = key if key is not None else jax.random.PRNGKey(j)
        gate = (
            cfg.min_similarity_vlad if self.vocab is not None
            else cfg.min_similarity
        )
        for n in order:
            if sims[n] < gate:
                break
            cand = past[int(n)]
            m = match_descriptors(
                cand.kp_desc, cur.kp_desc, cand.kp_valid, cur.kp_valid,
                ratio=cfg.match_ratio,
            )
            if int(m.valid.sum()) < cfg.min_matches:
                continue
            res = pnp_from_pixels(
                self.cam, cand.kp_p3d[m.idx_a], cur.kp_uv[m.idx_b],
                m.valid, key,
                threshold_px=cfg.pnp_threshold_px,
                min_inliers=cfg.pnp_min_inliers,
            )
            if not bool(res.ok):
                continue
            n_match = int(m.valid.sum())
            if int(res.num_inliers) < cfg.min_inlier_ratio * n_match:
                continue  # thin inlier fraction: typical of a false match set
            if cfg.check_reverse_pnp and not self._reverse_consistent(
                cand, cur, m, res, key
            ):
                continue
            # Depth-ratio dispersion gate (round-5 adversarial finding):
            # the per-inlier ratios of cand's 3D transformed into the cur
            # camera vs cur's OWN stored depths are tight for a true
            # revisit (scale drift shifts the median, prior noise sets the
            # scatter) and wide for corrupted/unrelated structure.
            p_pred = np.asarray(se3.apply(res.T, cand.kp_p3d[m.idx_a]))
            z_pred = p_pred[:, 2]
            z_cur = np.asarray(cur.kp_p3d)[np.asarray(m.idx_b)][:, 2]
            ok = (
                np.asarray(m.valid & res.inliers)
                & (z_pred > 1e-6) & (z_cur > 1e-6)
            )
            if ok.sum() >= 8:
                logr = np.log(z_pred[ok] / z_cur[ok])
                mad = float(np.median(np.abs(logr - np.median(logr))))
                if mad > cfg.max_scale_log_mad:
                    continue
            # res.T: cur camera <- cand camera  =>  T_ij (cand <- cur, world
            # chain convention of pose_graph: T_ij = T_i^-1 T_j).
            T_ij = np.linalg.inv(np.asarray(res.T, np.float32))
            # Relative monocular scale from the PnP-inlier depth ratio:
            # transform cand's 3D points (cand's scale gauge) into the cur
            # camera and compare against cur's OWN stored depths at the
            # matched keypoints — their median ratio is how much cur's map
            # scale drifted relative to cand's.
            scale = 1.0
            if cfg.use_sim3:
                if ok.sum() >= 8:
                    # z_pred is metric in cand's gauge; z_cur carries cur's
                    # drift d => median(z_pred/z_cur) = 1/d, which is exactly
                    # the edge's Sim(3) scale component: the residual
                    # log(S_ij^-1 S_i^-1 S_j) drives s_j/s_i toward it, and
                    # a node scale of 1/d deflates j's inflated map
                    # (verified both ways in TestSim3ScaleDriftCorrection:
                    # carrying d instead leaves 10x more endpoint error).
                    s = float(np.median(z_pred[ok] / z_cur[ok]))
                    if np.isfinite(s) and 0.2 < s < 5.0:
                        scale = s
            edge = LoopEdge(
                i=int(n), j=j, T_ij=T_ij,
                num_inliers=int(res.num_inliers), scale=scale,
            )
            self.loop_edges.append(edge)
            return edge
        return None

    def _reverse_consistent(self, cand, cur, m, res_fwd, key) -> bool:
        """Second-geometry gate: PnP in the mirror direction (cur's stored
        3D against cand's pixels) must produce a pose consistent with the
        forward solve. Composing forward @ backward should be ~identity;
        large rotation or translation disagreement flags a false loop."""
        from ..features import pnp_from_pixels

        cfg = self.config
        res_bwd = pnp_from_pixels(
            self.cam, cur.kp_p3d[m.idx_b], cand.kp_uv[m.idx_a],
            m.valid, jax.random.split(key)[1],
            threshold_px=cfg.pnp_threshold_px,
            min_inliers=cfg.pnp_min_inliers,
        )
        if not bool(res_bwd.ok):
            return False
        # A true revisit re-verifies most forward inliers in the mirror
        # direction; a lucky small consensus over corrupted structure does
        # not (round-5 adversarial finding — see LoopConfig).
        if int(res_bwd.num_inliers) < cfg.reverse_min_inlier_fraction * int(
            res_fwd.num_inliers
        ):
            return False
        # res_fwd.T: cur <- cand;  res_bwd.T: cand <- cur.
        D = np.asarray(res_fwd.T, np.float32) @ np.asarray(
            res_bwd.T, np.float32
        )
        xi = np.asarray(se3.log(jnp.asarray(D)))
        rot_err = float(np.linalg.norm(xi[3:]))
        trans_err = float(np.linalg.norm(xi[:3]))
        t_norm = float(np.linalg.norm(np.asarray(res_fwd.T)[:3, 3]))
        return rot_err <= cfg.reverse_max_rot and trans_err <= (
            cfg.reverse_max_trans_ratio * t_norm + 0.1
        )

    def update_poses(self, refined: dict[int, np.ndarray]) -> None:
        """Sync history with externally refined poses (window BA): without
        this, the next pose-graph optimization would start from the stale
        insertion-time chain and silently revert the BA refinements."""
        changed = False
        for k, r in enumerate(self.history):
            T = refined.get(r.frame_id)
            if T is not None:
                self.history[k] = r._replace(T_wc=np.asarray(T, np.float32))
                changed = True
        if changed:
            self.odo_rel = [
                np.linalg.inv(self.history[k].T_wc) @ self.history[k + 1].T_wc
                for k in range(len(self.history) - 1)
            ]

    # ------------------------------------------------------------ correction

    def optimize(self) -> dict[int, np.ndarray]:
        """Pose-graph LM over the whole keyframe history; returns
        {frame_id: corrected T_wc}. Buffers are bucket-padded so repeated
        closures reuse the compiled program.

        config.use_sim3 (default): nodes are Sim(3) and loop edges carry the
        PnP depth-ratio scale, so accumulated monocular scale drift is
        absorbed at closure (keyframe 3D points are rescaled by the solved
        per-node scales); otherwise SE(3)."""
        cfg = self.config
        M = len(self.history)
        E = (M - 1) + len(self.loop_edges)
        Mp = _bucket(M, 16)
        Ep = _bucket(E, 64)

        T = np.tile(np.eye(4, dtype=np.float32), (Mp, 1, 1))
        for k, r in enumerate(self.history):
            T[k] = r.T_wc
        ei = np.zeros(Ep, np.int32)
        ej = np.zeros(Ep, np.int32)
        Tij = np.tile(np.eye(4, dtype=np.float32), (Ep, 1, 1))
        w = np.zeros(Ep, np.float32)
        valid = np.zeros(Ep, bool)
        for k in range(M - 1):
            ei[k], ej[k] = k, k + 1
            Tij[k] = self.odo_rel[k]
            w[k] = cfg.odometry_weight
            valid[k] = True
        for k, e in enumerate(self.loop_edges):
            p = (M - 1) + k
            ei[p], ej[p] = e.i, e.j
            Tij[p] = e.T_ij
            if cfg.use_sim3 and e.scale != 1.0:
                # Measured relative Sim(3) i <- j: rotation/translation from
                # PnP (metric in kf_i's gauge), scale = drift of j's map
                # relative to i's (s_j / s_i at convergence).
                Tij[p] = np.asarray(
                    sim3.from_rst(
                        jnp.asarray(e.T_ij[:3, :3]),
                        jnp.asarray(np.float32(e.scale)),
                        jnp.asarray(e.T_ij[:3, 3]),
                    )
                )
            w[p] = cfg.loop_weight
            valid[p] = True

        if cfg.use_sim3:
            graph = Sim3PoseGraph(
                S_wc=jnp.asarray(T),
                edge_i=jnp.asarray(ei),
                edge_j=jnp.asarray(ej),
                S_ij=jnp.asarray(Tij),
                weight=jnp.asarray(w),
                valid=jnp.asarray(valid),
            )
            out = optimize_pose_graph_sim3(graph, max_iters=cfg.max_pgo_iters)
        else:
            graph = PoseGraph(
                T_wc=jnp.asarray(T),
                edge_i=jnp.asarray(ei),
                edge_j=jnp.asarray(ej),
                T_ij=jnp.asarray(Tij),
                weight=jnp.asarray(w),
                valid=jnp.asarray(valid),
            )
            out = optimize_pose_graph(graph, max_iters=cfg.max_pgo_iters)
        if not bool(jnp.isfinite(out.cost)) or float(out.cost) > float(
            out.initial_cost
        ):
            return {}
        S_new = np.asarray(out.T_wc)
        scales_ok = True
        if cfg.use_sim3:
            sc = np.asarray(
                [float(np.asarray(sim3.scale(jnp.asarray(S_new[k]))))
                 for k in range(M)]
            )
            scales_ok = bool(
                np.isfinite(sc).all() and (sc > 1e-3).all() and (sc < 1e3).all()
            )
        if not (np.isfinite(S_new[:M]).all() and scales_ok):
            # PGO produced non-finite poses or degenerate node scales
            # (observed on a 640-frame 4-revisit sequence with many stacked
            # Sim(3) edges): REJECT the correction — a NaN here would poison
            # every keyframe pose and the exported trajectory — and drop the
            # newest loop edge so the next optimization isn't re-broken by
            # the same constraint.
            if self.loop_edges:
                self.loop_edges.pop()
            return {}
        corrected = {}
        T_new = np.zeros((M, 4, 4), np.float32)
        for k, r in enumerate(self.history):
            if cfg.use_sim3:
                s_k = float(np.asarray(sim3.scale(jnp.asarray(S_new[k]))))
                Tk = np.eye(4, dtype=np.float32)
                Tk[:3, :3] = S_new[k][:3, :3] / s_k
                Tk[:3, 3] = S_new[k][:3, 3]
                # Node scale s_k ~ 1/d where d is this keyframe's map
                # inflation vs the anchor gauge; multiplying the stored
                # camera-frame structure by s_k deflates it back to metric
                # so future PnP relocalization/loop verification agrees.
                kp = r.kp_p3d * s_k if abs(s_k - 1.0) > 1e-4 else r.kp_p3d
            else:
                Tk = S_new[k]
                kp = r.kp_p3d
            T_new[k] = Tk
            self.history[k] = r._replace(T_wc=Tk, kp_p3d=kp)
            corrected[r.frame_id] = Tk
        # Refresh stored odometry to the corrected chain so future
        # optimizations start consistent.
        self.odo_rel = [
            np.linalg.inv(T_new[k]) @ T_new[k + 1] for k in range(M - 1)
        ]
        if cfg.use_sim3:
            # The solved per-node scales were folded into poses + map points;
            # nodes re-enter future optimizations at scale 1, so edge scales
            # must be re-gauged too or the same drift would be re-applied.
            self.loop_edges = [
                e._replace(scale=1.0) for e in self.loop_edges
            ]
        return corrected
