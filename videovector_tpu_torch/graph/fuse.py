"""Scoring-head fusion: horizontal batching of the embedding score motif;
counterpart of videovector_tpu/graph/fuse.py.

The flagship TRAIN graph (ref:projects/videovec_embedding/
mednet_embedding_train.prototxt:232-671 and generate_net.py's twin) slices
the shared tower output back into 1+C+K per-role blobs and runs K+2
NORMALIZATION layers, K+1 ELTWISE-PROD + SUM score chains and a CONCAT. In
eager PyTorch each of them is a handful of kernel launches forward and
backward, and the step is paced by the host that enqueues them (PERF.md).

The hand-written model (models/embedding.py) keeps the role axis as a
tensor axis: it views the (R·B, D) tower output as (R, B, D), normalizes
the negatives in one batch and scores them with one multiply-reduce. This
pass gives the prototxt engine the same structure without changing the
config surface: Net.apply interprets the motif layers SYMBOLICALLY (no
tensors computed) and materializes the blobs a real layer asks for (the
loss's bottoms) with batched role-major ops. Materialization is eager: the
tensors it makes are the ones autograd differentiates, so the backward of
the batched ops is the gradient.

Covered layer algebra (everything else falls back to normal interpretation,
per blob, automatically):

  SLICE(dim0, equal)  of a real blob         -> Role(i) symbols
  SLICE(dim0, equal)  of a Stack             -> its elements
  SLICE(dim1)         of a role-major input  -> DRole(i) symbols
  CONCAT(dim0)        of symbols             -> Stack
  CONCAT(dim1)        of Score symbols       -> the final score matrix
  ELTWISE SUM         of Role/Ctx symbols    -> Ctx (linear combination)
  ELTWISE PROD        of two vector symbols  -> Prod (stable gradient only)
  NORMALIZATION       of a vector symbol     -> Norm (distributes over Stack)
  SUM                 of a Prod              -> Score (row dot, broadcast)
  SILENCE             of symbols             -> absorbed

The materialized math is element for element the unfused layers' (the
same reduction axes, `ops/normalization.py`'s L2_NORM_EPS and zero-row
guard, ELTWISE SUM's fold order), so the loss is bit-equal to the unfused
Net's on the CPU; a gradient summed over the K negatives in one reduction
rather than by autograd's accumulation can differ in the last bit
(tests/test_torch_fuse.py).

Escape hatch: Net(fuse_scoring=False) or VVTPU_DISABLE_FUSION=1.
"""

from __future__ import annotations

import os

import torch

from videovector_tpu_torch.ops.normalization import L2_NORM_EPS


def fusion_enabled() -> bool:
    return os.environ.get("VVTPU_DISABLE_FUSION", "") not in ("1", "true")


# Symbols are nested tuples (hashable: materialization cache keys):
#   ("role", root_key, i)
#   ("drole", root_name, i)               axis-1 slice of a role-major input
#   ("ctx", ((coeff, sym), ...))          linear combination, listed order
#   ("norm", sym)
#   ("stack", (sym, ...))                 dim0-concat of equal-width vectors
#   ("prod", a, b)
#   ("score", a, b, num_output)           rowwise dot, broadcast to m cols
#   ("cat1", ((sym, ...),))               dim1-concat of Score symbols

_VECTORS = ("role", "drole", "ctx", "norm")


class ScoringFusion:
    """Per-apply symbolic state. Lives for one Net.apply call.

    `role_major` maps input blob names to their RAW (R, B, feat...) tensors
    when the caller feeds that blob role-major (Net.role_major_inputs): the
    leading SLICE(dim1) of the flagship graph then absorbs to `drole`
    symbols over axis 0 of the raw tensor, and the CONCAT(dim0) stack that
    feeds the tower materializes as a free reshape instead of the
    (B, R, D) -> (R, B, D) copy."""

    def __init__(self, role_major: dict | None = None):
        self.syms: dict[str, tuple] = {}      # blob name -> symbol
        # root (name, version) -> (tensor3, width, feat): keys are VERSIONED
        # so that a blob rebound in place between two same-name SLICEs gives
        # two distinct roots: symbols made before the rebinding keep their
        # pre-rewrite capture (that slice ran first), later slices capture
        # the new value (see note_rebind)
        self.roots: dict[tuple, tuple] = {}
        self.ver: dict[str, int] = {}
        self.rm: dict[str, torch.Tensor] = dict(role_major or {})
        # the role-major inputs as fed: note_rebind pops self.rm (gating
        # future absorbs) but live drole symbols still reference them
        self.rm_all: dict[str, torch.Tensor] = dict(self.rm)
        self._cache: dict[tuple, torch.Tensor] = {}
        # each root's roles as one unbind (its backward is one stack)
        self._unbound: dict[tuple, tuple] = {}
        self.absorbed_layers = 0              # introspection for tests/logs

    def note_rebind(self, name: str) -> None:
        """A layer rebound `name` to a real tensor: kill its symbol, stop
        absorbing its role-major raw input, and bump its root version so
        that a LATER SLICE of this name captures the new value."""
        self.syms.pop(name, None)
        self.rm.pop(name, None)
        self.ver[name] = self.ver.get(name, 0) + 1

    # -- absorption ----------------------------------------------------

    def try_absorb(self, layer, blobs, loss_weights) -> list[str] | None:
        """If this layer is expressible symbolically, record symbols for its
        tops and return the top names; else None (normal path)."""
        ltype = layer.get("type")
        if ltype not in ("SLICE", "CONCAT", "ELTWISE", "NORMALIZATION",
                         "SUM", "SILENCE"):
            return None
        if any(w != 0.0 for w in loss_weights):
            return None
        tops = [str(t) for t in layer.get_list("top")]
        bottoms = [str(b) for b in layer.get_list("bottom")]
        out = self._absorb(ltype, layer, tops, bottoms, blobs)
        if out is None:
            return None
        for t, s in zip(tops, out):
            self.syms[t] = s
            blobs.pop(t, None)   # the symbol shadows a stale tensor binding
        self.absorbed_layers += 1
        return tops

    def _absorb(self, ltype, layer, tops, bottoms, blobs):
        bsyms = [self.syms.get(b) for b in bottoms]

        if ltype == "SILENCE":
            return [] if all(s is not None for s in bsyms) else None
        if ltype == "SLICE":
            return self._absorb_slice(layer, tops, bottoms[0], bsyms[0], blobs)

        if ltype == "CONCAT":
            dim = int(layer.get_msg("concat_param").get("concat_dim", 1))
            if any(s is None for s in bsyms):
                return None
            if dim == 0:
                ws = {self._sym_width(s) for s in bsyms}
                if None in ws or len(ws) != 1:
                    return None
                return [("stack", tuple(bsyms))]
            if dim == 1 and all(s[0] == "score" for s in bsyms):
                return [("cat1", tuple(bsyms))]
            return None

        if ltype == "ELTWISE":
            p = layer.get_msg("eltwise_param")
            op = p.get("operation", "SUM")
            if any(s is None for s in bsyms):
                return None
            if op == "SUM":
                coeffs = [float(c) for c in p.get_list("coeff")] \
                    or [1.0] * len(bsyms)
                if len(coeffs) != len(bsyms) or \
                        not all(s[0] in _VECTORS for s in bsyms):
                    return None
                return [("ctx", tuple(zip(coeffs, bsyms)))]
            if op == "PROD" and len(bsyms) == 2 \
                    and bool(p.get("stable_prod_grad", True)) \
                    and all(s[0] in _VECTORS for s in bsyms):
                # stable_prod_grad: false selects the reference's DIVISION
                # backward (reductions._ProdDivGrad); the fused product's
                # gradient is the stable form, so such a layer stays unfused
                return [("prod", bsyms[0], bsyms[1])]
            return None

        if ltype == "NORMALIZATION":
            s = bsyms[0]
            if s is None:
                return None
            if s[0] == "stack":
                return [("stack", tuple(("norm", e) for e in s[1]))]
            if s[0] in _VECTORS:
                return [("norm", s)]
            return None

        if ltype == "SUM":
            s = bsyms[0]
            if s is None or s[0] != "prod":
                return None
            m = int(layer.get_msg("sum_param").get("num_output", 1))
            return [("score", s[1], s[2], m)]
        return None

    def _absorb_slice(self, layer, tops, src, bsym, blobs):
        p = layer.get_msg("slice_param")
        dim = int(p.get("slice_dim", 1))
        points = [int(v) for v in p.get_list("slice_point")]
        n = len(tops)
        if dim == 1:
            # role-major-fed root: axis-1 slices of the logical
            # (B, R, feat...) blob are axis-0 slices of the raw tensor
            if bsym is not None or src not in self.rm:
                return None
            arr = self.rm[src]
            if arr.dim() < 2 or arr.shape[0] != n:
                return None   # only all-width-1 slices
            if points and points != list(range(1, n)):
                return None
            return [("drole", src, i) for i in range(n)]
        if dim != 0:
            return None
        if bsym is None:
            arr = blobs.get(src)
            if not isinstance(arr, torch.Tensor):
                return None
            shape = tuple(arr.shape)
            if len(shape) < 2 or shape[0] % n != 0:
                return None
            w = shape[0] // n
            if points and points != [w * i for i in range(1, n)]:
                return None
            key = (src, self.ver.get(src, 0))
            if key not in self.roots:
                self.roots[key] = (arr.reshape((n, w) + shape[1:]), w,
                                   shape[1:])
            elif self.roots[key][1] != w:
                return None   # the same root sliced at another width
            return [("role", key, i) for i in range(n)]
        if bsym[0] == "stack":
            elems = bsym[1]
            if len(elems) != n:
                return None
            if points:
                # equal-width elements by construction; explicit points
                # must sit on their boundaries
                ws = self._sym_width(elems[0])
                if ws is None or points != [ws * i for i in range(1, n)]:
                    return None
            return list(elems)
        return None

    def _sym_width(self, sym):
        """Row count of a vector symbol, if statically known."""
        if sym[0] == "role":
            return self.roots[sym[1]][1]
        if sym[0] == "drole":
            return self.rm_all[sym[1]].shape[1]
        if sym[0] == "ctx":
            return self._sym_width(sym[1][0][1])
        if sym[0] == "norm":
            return self._sym_width(sym[1])
        return None

    # -- materialization ----------------------------------------------

    def materialize(self, name_or_sym):
        sym = self.syms[name_or_sym] if isinstance(name_or_sym, str) \
            else name_or_sym
        return self._mat(sym)

    def _roles(self, key) -> tuple:
        roles = self._unbound.get(key)
        if roles is None:
            roles = self._unbound[key] = self.roots[key][0].unbind(0)
        return roles

    def _mat(self, sym):
        hit = self._cache.get(sym)
        if hit is not None:
            return hit
        kind = sym[0]
        if kind == "role":
            out = self._roles(sym[1])[sym[2]]
        elif kind == "drole":
            # the logical (B, 1, feat...) slice of the (R, B, feat...) input
            out = self.rm_all[sym[1]][sym[2]].unsqueeze(1)
        elif kind == "ctx":
            # folded in listed order: reductions.eltwise_sum's accumulation
            terms = sym[1]
            out = terms[0][0] * self._mat(terms[0][1])
            for c, s in terms[1:]:
                out = out + c * self._mat(s)
        elif kind == "norm":
            out = _l2n_feat(self._mat(sym[1]))
        elif kind == "stack":
            out = self._mat_stack(sym[1])
        elif kind == "prod":
            out = self._mat(sym[1]) * self._mat(sym[2])
        elif kind == "score":
            out = self._mat_score(sym)
        elif kind == "cat1":
            out = self._mat_cat1(sym[1])
        else:  # pragma: no cover
            raise AssertionError(f"unknown symbol {sym!r}")
        self._cache[sym] = out
        return out

    def _mat_stack(self, elems):
        """dim0-concat of the element symbols. A full in-order drole cover
        of one role-major input is a reshape of it: the concat of its axis-0
        slices IS that tensor laid out role-major, so no data moves."""
        if all(e[0] == "drole" for e in elems) \
                and len({e[1] for e in elems}) == 1:
            arr = self.rm_all[elems[0][1]]
            if [e[2] for e in elems] == list(range(arr.shape[0])):
                r, b = arr.shape[0], arr.shape[1]
                return arr.reshape((r * b, 1) + tuple(arr.shape[2:]))
        return torch.cat([self._mat(e) for e in elems], dim=0)

    def _mat_score(self, sym):
        # reductions.sum_reduce of the product
        _, a, b, m = sym
        prod = self._mat(("prod", a, b))
        s = torch.sum(prod.reshape(prod.shape[0], -1), dim=1, keepdim=True)
        return s if m == 1 else torch.broadcast_to(s, (prod.shape[0], m))

    def _mat_cat1(self, scores):
        """The payoff: K negative scores that share one left operand, with
        norm-of-role right operands of one root, are ONE batched normalize
        and multiply-reduce over a (K, B, feat...) role block: the
        hand-written model's structure."""
        left = scores[0][1]
        rights = [s[2] for s in scores]
        batched = (
            all(s[1] == left for s in scores)
            and all(r[0] == "norm" and r[1][0] == "role" for r in rights)
            and len({r[1][1] for r in rights}) == 1
        )
        if not batched:
            return torch.cat([self._mat(s) for s in scores], dim=1)
        roles = self._roles(rights[0][1][1])
        block = torch.stack([roles[r[1][2]] for r in rights])
        rn = _l2n_feat(block, rows_ndim=2)            # (K, B, feat...)
        am = self._mat(left)                          # (B, feat...)
        k, b = rn.shape[0], rn.shape[1]
        dots = torch.sum((am.unsqueeze(0) * rn).reshape(k, b, -1), dim=2)
        cols = dots.t().contiguous()                  # (B, K)
        ms = [s[3] for s in scores]
        if all(m == 1 for m in ms):
            return cols
        return torch.repeat_interleave(
            cols, torch.tensor(ms, device=cols.device), dim=1)


def _l2n_feat(x, eps: float = L2_NORM_EPS, rows_ndim: int = 1):
    """ops.normalization.l2_normalize_rows with the row prefix spanning
    `rows_ndim` leading axes: the same per-row math (eps added to the norm,
    a zero row gives 0), batched over the role axis."""
    feat_dims = tuple(range(rows_ndim, x.dim()))
    sq = torch.sum(x * x, dim=feat_dims, keepdim=True)
    nonzero = sq > 0
    safe_norm = torch.sqrt(torch.where(nonzero, sq, torch.ones_like(sq)))
    return torch.where(nonzero, x / (safe_norm + eps), torch.zeros_like(x))
