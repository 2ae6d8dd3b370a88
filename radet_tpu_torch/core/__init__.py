from .anchors import AnchorConfig, anchor_featmap_sizes, generate_anchors
from .box_coder import tblr_decode

__all__ = ["AnchorConfig", "anchor_featmap_sizes", "generate_anchors", "tblr_decode"]
