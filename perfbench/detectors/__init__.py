"""Detectors of the e2e cells, one module a file, found by the name that
the configuration gives under its `detector` key (absent: `detic`), as a
per-layer metric's reader is found by the metric's name.

A detector's module holds everything of a configuration that is particular
to its detector; the harness keeps what every detector shares: SAM, the
content swap of detections and planes, the prompts, the mask and box
comparisons, the lift and the window's clock. A module gives:

- `skeleton(cfg)`: {prefix: plain reference module}, built by the caller
  on `meta`; weights.make_state draws the detector's weights from these
  before SAM's, and checks.build_reference loads them into the float32
  reference.
- `text_inputs(cfg, seed, device)`: what the detector reads of the
  vocabulary, made from the seed and handed to both sides.
- `port_models(cfg, state, make_sam, text, device, quant_int8)`: (the
  port's MaskModels, its detector module, its SAM module): the detector
  built from the configuration, holding the state's weights, then the
  port's float SAM from `make_sam()`, both made int8 by the port where the
  configuration serves int8, then the MaskModels around them.
- `captures(module)`: [(key, submodule)] of the port's detector whose
  outputs the sample keeps, and `program_side(cap)`, those outputs as
  `reference_side` gives its own.
- `set_precision(ref, cfg, control)`: the reference's layers ({prefix:
  module} of `skeleton`) at the configuration's precisions, or with
  `control` one step below each.
- `reference_side(ref, text, images, x, cfg, prog)`: what the reference
  gives for one keyframe's uint8 images (`x`: normalised), where it starts
  from the program's side `prog` (None: from its own).
- `compare(prog, ref)`: {number: value}, the detector's numbers compared
  for `correct` (limits/<cell>.json), and any read beside them.
- `work(cfg, traffic, quant_int8)`: {precision class: operations} of a
  keyframe's detector, for mfu_pct; `window_attn_input(cfg, traffic)`:
  (Swin sizes, images, h, w) at which the window-attention kernels run.
"""

from __future__ import annotations

import importlib

DEFAULT = "detic"
FUNCTIONS = ("skeleton", "text_inputs", "port_models", "captures", "program_side",
             "set_precision", "reference_side", "compare", "work", "window_attn_input")


def of(cfg: dict):
    """The configuration's detector module."""
    return importlib.import_module(f"perfbench.detectors.{cfg.get('detector', DEFAULT)}")
