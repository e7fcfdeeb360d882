"""A CVP-MVSNet serving cell for the CPU tests: its configuration is given
inline (no configuration file names it), small enough for the CPU. The
`cvp` fixture (conftest.py) makes `files.config` find it."""
from mvsbench import files

#: the exact gather and three levels at 64x96 (coarsest 16x24): at a
#: coarsest level of 4x6 a pixel spans hundreds of mm, and the one-pixel
#: epipolar steps there swing with the last bits of the geometry
CVP_CONFIG = {
    "name": "cvp_mvsnet_test",
    "architecture": "cvp_mvsnet",
    "predictor": {"cvp_nscale": 3, "sweep_method": "gather"},
    "logit_gain": {"cost_reg_refine.prob0": 3.0},
    "regularizer_modules": ["cost_reg_refine"],
    "stage_modules": [],
    "score_modules": ["cost_reg_refine"],
    "score_channel_axis": False,
}

#: the bf16 program on the CPU reads at most 0.084 (score_err), 0.83
#: (depth_mean_itv, the coarsest level) and exactly 0 (the regressions)
#: over five seeds
CVP_LIMITS = {
    "score_err_stage1": 0.2, "score_err_stage2": 0.2, "score_err_stage3": 0.2,
    "depth_mean_itv_stage1": 2.0, "depth_mean_itv_stage2": 2.0,
    "depth_mean_itv_stage3": 2.0, "depth_regress_itv": 1e-3,
    "conf_regress_abs": 1e-4,
}

CVP_CELL = "cvp_mvsnet_test.serve_64x96_n3"


def cvp_cell() -> dict:
    cell = files.workload("vis_mvsnet_64_32_16.serve_1184x1600_n5")
    cell.update(name=CVP_CELL, config=CVP_CONFIG["name"],
                traffic="serve_64x96_n3", height=64, width=96, views=3,
                warmup_requests=1, check_requests=2, limits=CVP_LIMITS)
    cell["rig"] = dict(cell["rig"], focal={"64x96": 173.52})
    return cell
