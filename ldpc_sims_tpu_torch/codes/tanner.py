"""Tanner-graph edge compiler: sparse H → padded slot layouts.

The port's copy of ``ldpc_sims_tpu.codes.tanner`` (NumPy only). The JAX
package's docs follow. This is the TPU-native successor of the reference's dense-mask compiler
``bp/masking.py:12-147`` (``generate_masks``), which flattened the Tanner
graph into four dense 0/1 matrices (E×E message-routing masks) and made the
decoder a stack of E×E matmuls with O(B·E²)–O(B·E³) cost. Here the graph is
compiled instead into *padded slot layouts* with O(E) state:

* **check space** — messages live canonically as ``(n_checks, dc, batch)``;
  slot ``(c, i)`` is the i-th edge of check c. Padding slots (for checks of
  degree < dc) are inert.
* **variable space** — the same edges viewed as ``(n_vars, dv, batch)``;
  slot ``(v, j)`` is the j-th edge of variable v.

One iteration of BP is then: a static row-gather mapping check space →
variable space, small-axis (dv) reductions for the variable update, the
inverse gather, and small-axis (dc) reductions for the check update. With
batch as the minor (lane) dimension both gathers are contiguous row moves,
which XLA/Mosaic tile efficiently; there are no E×E matmuls anywhere.

Edge ordering convention: edges are enumerated check-major (by increasing
(check, variable)), the same linearization the reference's ``clookup``
table uses (``bp/masking.py:75-95``), so per-edge quantities (e.g. neural-BP
weights) are directly comparable.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = ["TannerGraph"]


@dataclasses.dataclass(frozen=True)
class TannerGraph:
    """Compiled Tanner graph. All arrays are host NumPy; they become
    constants inside jitted decoders.

    Attributes:
      n_vars: number of variable nodes (codeword length n).
      n_checks: number of check nodes (rows of H).
      n_edges: number of edges E = sum(H).
      dc: padded max check degree (slots per check).
      dv: padded max variable degree (slots per variable).
      edge_var: (E,) variable index of each edge, check-major order.
      edge_check: (E,) check index of each edge, check-major order.
      cslot_of_edge: (E,) flat check-space slot (c*dc + i) of each edge.
      vslot_of_edge: (E,) flat variable-space slot (v*dv + j) of each edge.
      to_var_space: (n_vars*dv,) for each variable-space slot, the flat
        check-space slot holding the same edge, or ``n_checks*dc`` (one
        past the end) for padding slots — use with a fill gather.
      to_check_space: (n_checks*dc,) inverse map, padding → ``n_vars*dv``.
      c_mask: (n_checks, dc) bool validity of check slots.
      v_mask: (n_vars, dv) bool validity of variable slots.
      c_deg: (n_checks,) true check degrees.
      v_deg: (n_vars,) true variable degrees.
    """

    n_vars: int
    n_checks: int
    n_edges: int
    dc: int
    dv: int
    edge_var: np.ndarray
    edge_check: np.ndarray
    cslot_of_edge: np.ndarray
    vslot_of_edge: np.ndarray
    to_var_space: np.ndarray
    to_check_space: np.ndarray
    c_mask: np.ndarray
    v_mask: np.ndarray
    c_deg: np.ndarray
    v_deg: np.ndarray

    @staticmethod
    def from_H(
        H: np.ndarray, dc: int | None = None, dv: int | None = None
    ) -> "TannerGraph":
        """Compile a dense 0/1 parity-check matrix into slot layouts."""
        H = np.asarray(H, dtype=np.uint8) & 1
        m, n = H.shape
        c_deg = H.sum(axis=1).astype(np.int32)
        v_deg = H.sum(axis=0).astype(np.int32)
        dc_ = int(c_deg.max()) if dc is None else int(dc)
        dv_ = int(v_deg.max()) if dv is None else int(dv)
        if dc_ < c_deg.max() or dv_ < v_deg.max():
            raise ValueError("requested slot counts below actual degrees")

        # check-major edge enumeration (rows scanned in order, cols ascending)
        checks, vars_ = np.nonzero(H)
        # np.nonzero on a 2-D array is already row-major sorted
        E = checks.size
        edge_check = checks.astype(np.int32)
        edge_var = vars_.astype(np.int32)

        # slot within its check: position of the edge among its row's edges
        pos_in_check = np.zeros(E, dtype=np.int32)
        next_slot = np.zeros(m, dtype=np.int32)
        for e in range(E):
            c = edge_check[e]
            pos_in_check[e] = next_slot[c]
            next_slot[c] += 1

        # slot within its variable: edges of v in order of increasing check
        pos_in_var = np.zeros(E, dtype=np.int32)
        next_vslot = np.zeros(n, dtype=np.int32)
        for e in range(E):  # check-major scan == increasing check per var
            v = edge_var[e]
            pos_in_var[e] = next_vslot[v]
            next_vslot[v] += 1

        cslot_of_edge = (edge_check * dc_ + pos_in_check).astype(np.int32)
        vslot_of_edge = (edge_var * dv_ + pos_in_var).astype(np.int32)

        c_pad, v_pad = m * dc_, n * dv_
        to_var_space = np.full(v_pad, c_pad, dtype=np.int32)
        to_var_space[vslot_of_edge] = cslot_of_edge
        to_check_space = np.full(c_pad, v_pad, dtype=np.int32)
        to_check_space[cslot_of_edge] = vslot_of_edge

        c_mask = np.zeros((m, dc_), dtype=bool)
        c_mask[edge_check, pos_in_check] = True
        v_mask = np.zeros((n, dv_), dtype=bool)
        v_mask[edge_var, pos_in_var] = True

        return TannerGraph(
            n_vars=n,
            n_checks=m,
            n_edges=E,
            dc=dc_,
            dv=dv_,
            edge_var=edge_var,
            edge_check=edge_check,
            cslot_of_edge=cslot_of_edge,
            vslot_of_edge=vslot_of_edge,
            to_var_space=to_var_space,
            to_check_space=to_check_space,
            c_mask=c_mask,
            v_mask=v_mask,
            c_deg=c_deg,
            v_deg=v_deg,
        )

    @functools.cached_property
    def dense_routing(self) -> dict[str, np.ndarray]:
        """Dense 0/1 routing matrices in padded check space (float32).

        The MXU decode backend for small codes: one BP variable update is
        two matmuls with these constants —
        ``v2c = W_v @ c2v + L_exp @ Lv`` where

        * ``W_v`` (Ec×Ec): routes check-space slot b into slot a iff both
          are valid edges of the same variable and a ≠ b (the reference's
          ``mask_v``/``mask_c`` idea, ``bp/masking.py:97-138``, but in a
          single check-major linearization and used only for small codes
          where O(E²) is free);
        * ``L_exp`` (Ec×n): replicates each variable's channel LLR onto
          its edge slots (the reference's ``llr_expander``);
        * ``M_fin`` (n×Ec): marginalization map (``mask_v_final``).

        Ec = n_checks·dc; padding slots have all-zero rows/columns so
        their garbage never propagates.
        """
        Ec = self.n_checks * self.dc
        var_of_slot = np.full(Ec, -1, dtype=np.int64)
        var_of_slot[self.cslot_of_edge] = self.edge_var
        valid = var_of_slot >= 0
        same_var = (
            (var_of_slot[:, None] == var_of_slot[None, :])
            & valid[:, None]
            & valid[None, :]
        )
        W_v = (same_var & ~np.eye(Ec, dtype=bool)).astype(np.float32)
        L_exp = np.zeros((Ec, self.n_vars), dtype=np.float32)
        L_exp[valid, var_of_slot[valid]] = 1.0
        M_fin = L_exp.T.copy()
        return {"W_v": W_v, "L_exp": L_exp, "M_fin": M_fin}

    @functools.cached_property
    def factored_routing(self) -> dict[str, np.ndarray]:
        """Rectangular routing for large non-QC codes (no Ec×Ec matrix).

        ``W_v`` factors exactly as ``L_exp @ M_fin − I`` on valid slots,
        so one BP variable update becomes two RECTANGULAR one-hot
        matmuls — ``v2c = L_exp @ (M_fin @ x + lv) − x`` — at
        O(n·Ec·B) MXU work and O(n·Ec) constant memory instead of the
        dense backend's O(Ec²). This is the TPU path for arbitrary
        (alist/PEG) codes: per-edge gathers chained through the decode
        loop crash the XLA TPU fusion pass (see ops/bp.py module docs),
        and one-hot matmuls are the idiomatic MXU replacement.
        """
        Ec = self.n_checks * self.dc
        var_of_slot = np.full(Ec, -1, dtype=np.int64)
        var_of_slot[self.cslot_of_edge] = self.edge_var
        valid = var_of_slot >= 0
        L_exp = np.zeros((Ec, self.n_vars), dtype=np.float32)
        L_exp[valid, var_of_slot[valid]] = 1.0
        return {"L_exp": L_exp, "M_fin": L_exp.T.copy()}

    # -- dense reconstructions (tests / debugging only) ------------------

    def dense_masks(self) -> dict[str, np.ndarray]:
        """Reconstruct the reference's four dense masks from the edge lists.

        Semantics per ``bp/masking.py``: ``mask_v[out_edge, in_edge] = 1``
        iff in/out edges share a variable but not the edge itself
        (``:97-113``); ``mask_c`` the converse for checks (``:129-138``);
        ``mask_v_final[v, e] = 1`` iff edge e touches variable v
        (``:115-127``); ``llr_expander[e, v] = 1`` iff edge e touches v
        (``:57-68``). One difference: the reference indexes VC-layer output
        edges variable-major (its ``vlookup``) and CV-layer output edges
        check-major (``clookup``); here a single check-major linearization
        is used for both axes, i.e. these are the reference masks with the
        var-major axis permuted by ``argsort(vslot_of_edge)``. Used only to
        prove equivalence in unit tests.
        """
        E = self.n_edges
        ev, ec = self.edge_var, self.edge_check
        same_var = ev[:, None] == ev[None, :]
        same_check = ec[:, None] == ec[None, :]
        eye = np.eye(E, dtype=bool)
        mask_v = (same_var & ~eye).astype(np.float64)
        mask_c = (same_check & ~eye).astype(np.float64)
        mask_v_final = np.zeros((self.n_vars, E))
        mask_v_final[ev, np.arange(E)] = 1.0
        llr_expander = mask_v_final.T.copy()
        return {
            "mask_v": mask_v,
            "mask_c": mask_c,
            "mask_v_final": mask_v_final,
            "llr_expander": llr_expander,
        }
