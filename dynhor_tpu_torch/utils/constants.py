"""Pipeline constants (reference: ObjTracker/utils/constants.py).

These are the DEFAULTS; unlike the reference they are all overridable from
the YAML config (SURVEY.md §5 'config system' gap).
"""

FOCAL_LENGTH = 1.0  # NDC focal for prior renders (PyTorch3D default)
REND_SIZE = 256  # side of target-mask crops for the silhouette losses
BBOX_EXPANSION_FACTOR = 0.3  # square-crop padding around the tight bbox
RENDER_H, RENDER_W = 384, 384  # prior-view render resolution

BBOX_EXPANSION = {"default": BBOX_EXPANSION_FACTOR}
BBOX_EXPANSION_PARTS = {"default": BBOX_EXPANSION_FACTOR}
