# Copied from av1tpu/specav1/cdfs.py.
"""Spec default CDF tables and the adaptive frame context.

Loads ``av1tpu/encoder/entropy/av1_default_cdfs.npz`` (extracted from
the system libaom/gav1 binaries by tools/extract_cdfs.py — the AV1
spec's "Default CDF Tables") and exposes a FrameContext of mutable
arrays in ICDF-with-counter layout, reset per spec on keyframes.

Indexing conventions (row-major flattening of the spec dims):
  coeff tables lead with the base_q_idx quartile context (spec
  get_q_ctx: q <= 20 -> 0, <= 60 -> 1, <= 120 -> 2, else 3).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_NPZ = Path(__file__).resolve().parent.parent / "encoder" / "entropy" / \
    "av1_default_cdfs.npz"

_raw: dict | None = None


def _tables() -> dict:
    global _raw
    if _raw is None:
        with np.load(_NPZ) as z:
            _raw = {k: z[k] for k in z.files}
    return _raw


def q_ctx(base_q_idx: int) -> int:
    if base_q_idx <= 20:
        return 0
    if base_q_idx <= 60:
        return 1
    if base_q_idx <= 120:
        return 2
    return 3


# spec tx-size classes for coefficient coding (TX_4X4 .. TX_64X64 square
# context index used by txb_skip/coeff tables): txs_ctx = min(txsz_sqr_up?,
# handled by caller)

class FrameContext:
    """Mutable per-frame CDF state (int32 working copies)."""

    def __init__(self, base_q_idx: int):
        t = _tables()
        q = q_ctx(base_q_idx)

        def cp(name, shape=None, qslice=False):
            a = t[name].astype(np.int32)
            if qslice:
                # leading dim is flattened [4][...]: slice our quartile
                rows = a.shape[0] // 4
                a = a[q * rows:(q + 1) * rows]
            if shape is not None:
                a = a.reshape(*shape, a.shape[-1])
            return a.copy()

        # coefficient CDFs (per-frame quartile slice)
        self.txb_skip = cp("txb_skip", (5, 13), qslice=True)
        self.eob_extra = cp("eob_extra", (5, 2, 9), qslice=True)
        self.dc_sign = cp("dc_sign", (2, 3), qslice=True)
        self.eob_pt = {
            16: cp("eob_pt_16", (2, 2), qslice=True),
            32: cp("eob_pt_32", (2, 2), qslice=True),
            64: cp("eob_pt_64", (2, 2), qslice=True),
            128: cp("eob_pt_128", (2, 2), qslice=True),
            256: cp("eob_pt_256", (2, 2), qslice=True),
            512: cp("eob_pt_512", (2, 2), qslice=True),
            1024: cp("eob_pt_1024", (2, 2), qslice=True),
        }
        self.coeff_base_eob = cp("coeff_base_eob", (5, 2, 4), qslice=True)
        self.coeff_base = cp("coeff_base", (5, 2, 42), qslice=True)
        self.coeff_br = cp("coeff_br", (5, 2, 21), qslice=True)
        # mode CDFs
        self.kf_y_mode = cp("kf_y_mode", (5, 5))
        self.if_y_mode = cp("if_y_mode", (4,))
        self.uv_mode = cp("uv_mode", (2, 13))
        self.angle_delta = cp("angle_delta", (8,))
        self.cfl_sign = cp("cfl_sign")[0]
        self.cfl_alpha = cp("cfl_alpha", (6,))
        self.filter_intra_mode = cp("filter_intra_mode")[0]
        self.filter_intra = cp("filter_intra", (22,))
        self.partition = cp("partition", (5, 4))
        self.tx_size = cp("tx_size", (4, 3))
        self.txfm_partition = cp("txfm_partition", (21,))
        self.intra_ext_tx = cp("intra_ext_tx", (3, 4, 13))
        self.inter_ext_tx = cp("inter_ext_tx", (4, 4))
        self.skip = cp("skip", (3,))
        self.skip_mode = cp("skip_mode", (3,))
        self.intra_inter = cp("intra_inter", (4,))
        self.comp_inter = cp("comp_inter", (5,))
        self.comp_ref_type = cp("comp_ref_type", (5,))
        self.uni_comp_ref = cp("uni_comp_ref", (3, 3))
        self.single_ref = cp("single_ref", (3, 6))
        self.comp_ref = cp("comp_ref", (3, 3))
        self.comp_bwdref = cp("comp_bwdref", (3, 2))
        self.newmv = cp("newmv", (6,))
        self.zeromv = cp("zeromv", (2,))
        self.refmv = cp("refmv", (6,))
        self.drl = cp("drl", (3,))
        self.inter_compound_mode = cp("inter_compound_mode", (8,))
        self.interintra = cp("interintra", (4,))
        self.interintra_mode = cp("interintra_mode", (4,))
        self.wedge_interintra = cp("wedge_interintra", (22,))
        self.compound_type = cp("compound_type", (22,))
        self.wedge_idx = cp("wedge_idx", (22,))
        self.motion_mode = cp("motion_mode", (22,))
        self.obmc = cp("obmc", (22,))
        self.comp_group_idx = cp("comp_group_idx", (7,))
        self.compound_idx = cp("compound_idx", (6,))
        self.switchable_interp = cp("switchable_interp", (16,))
        self.delta_q = cp("delta_q")[0]
        self.delta_lf = cp("delta_lf", (5,))
        self.intrabc = cp("intrabc")[0]
        self.restore_wiener = cp("restore_wiener")[0]
        self.restore_sgrproj = cp("restore_sgrproj")[0]
        self.restore_switchable = cp("restore_switchable")[0]
        self.segment_pred = cp("segment_pred", (3,))
        self.spatial_seg = cp("spatial_seg", (3,))
        self.palette_y_size = cp("palette_y_size", (7,))
        self.palette_uv_size = cp("palette_uv_size", (7,))
        self.palette_y_mode = cp("palette_y_mode", (7, 3))
        self.palette_uv_mode = cp("palette_uv_mode", (2,))
        self.palette_y_color = cp("palette_y_color", (7, 5))
        self.palette_uv_color = cp("palette_uv_color", (7, 5))
        # mv contexts: joint + per-component structs
        self.mv_joint = cp("mv_joint")[0]
        self.mv = [MvComponentCdfs(t, c) for c in range(2)]


class MvComponentCdfs:
    """One nmv_component's CDFs (spec: classes, class0, bits, fp, hp,
    sign).  Extracted as distinct tables mv_comp_{c}_* when solved."""

    def __init__(self, t: dict, comp: int):
        def g(name, squeeze=False):
            key = f"mv_comp{comp}_{name}"
            if key not in t:
                return None
            a = t[key].astype(np.int32).copy()
            if squeeze and a.ndim == 2 and a.shape[0] == 1:
                a = a[0]
            return a
        self.classes = g("classes", squeeze=True)
        self.class0 = g("class0", squeeze=True)
        self.bits = g("bits")              # (10, 3)
        self.class0_fp = g("class0_fp")    # (2, 5)
        self.fp = g("fp", squeeze=True)
        self.sign = g("sign", squeeze=True)
        self.class0_hp = g("class0_hp", squeeze=True)
        self.hp = g("hp", squeeze=True)
