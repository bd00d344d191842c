"""The port's benchmark entry: one stage's throughput as ONE JSON line.

    python -m cm3d_tpu_torch.bench                     # the lift stage
    python -m cm3d_tpu_torch.bench --stage lift | masks | e2e | train | fusion_train
    python -m cm3d_tpu_torch.bench --stage masks|e2e [--rect_encode] \\
        [--quant_int8 [--quant_static]] [--sam_size vit_h|vit_l|vit_b]
    python -m cm3d_tpu_torch.bench --stage e2e --profile fast
    python -m cm3d_tpu_torch.bench --stage fusion_train [--swin_camera \\
        [--no_camera_fused]] [--camera_bf16]

The default run prints the lift-stage throughput (the fused 3D lift step;
reference: the src/nuscenes/2d_to_3d.py main loop). That is NOT the
end-to-end number: the full pipeline is bound by the 2D mask stage, and
the fused images -> masks -> boxes throughput is `--stage e2e`
(`benchmarks.bench_e2e`, random full-width weights; see
cm3d_tpu_torch/benchmarks.py for the protocol and its content swap).
`--stage e2e --profile fast` composes the opt-in speed modes (SAM size x
rect encode x int8) in one process and prints one line whose points carry
each mode's ms a keyframe and accuracy envelope.

The flags parse as the JAX package's `bench.py` does, with its checks in
its order and its messages: a typo'd stage, or a flag given to a stage it
does not apply to, exits non-zero and prints no JSON, so a run can never
record one stage's number as another's. The run is on CUDA
(`utils.device.resolve_device`); there is no CPU fallback. Standard output
holds the result line alone: everything else the run prints (kernel
builds, warnings, peak memory) goes to standard error.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

STAGES = (None, "lift", "masks", "e2e", "train", "fusion_train")


@contextlib.contextmanager
def _stdout_to_stderr():
    """Send what the body prints to stderr, from Python and from child
    processes or native code alike (file descriptor 1 included)."""
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        os.dup2(2, 1)
        with contextlib.redirect_stdout(sys.stderr):
            yield
    finally:
        sys.stderr.flush()
        os.dup2(saved, 1)
        os.close(saved)


def _emit(d: dict) -> None:
    print(json.dumps(d), flush=True)


def _value(argv: list, flag: str, choices: tuple, message: str):
    """The word after `flag`, or None without it; SystemExit(message) when
    it is missing or not one of `choices` (None: any word)."""
    if flag not in argv:
        return None
    i = argv.index(flag) + 1
    if i >= len(argv) or (choices is not None and argv[i] not in choices):
        raise SystemExit(message)
    return argv[i]


def parse(argv: list) -> dict:
    """The bench call an argv asks for: {"stage", "profile", "kwargs"};
    SystemExit with the JAX entry's message for every argv it refuses."""
    stage = _value(argv, "--stage", None,
                   "--stage needs a value: lift | masks | e2e | train | fusion_train")
    if stage not in STAGES:
        # NEVER fall through to the lift headline on a typo: a caller that
        # asked for a specific stage would record a lift number as that
        # stage's result.
        raise SystemExit(f"unknown --stage {stage!r}")

    rect_encode = "--rect_encode" in argv
    quant_int8 = "--quant_int8" in argv
    quant_static = "--quant_static" in argv
    if quant_static and not quant_int8:
        raise SystemExit("--quant_static requires --quant_int8")
    sam_size = _value(argv, "--sam_size", ("vit_h", "vit_l", "vit_b"),
                      "--sam_size needs vit_h | vit_l | vit_b") or "vit_h"
    profile = _value(argv, "--profile", ("fast",), "--profile supports: fast")
    if (rect_encode or quant_int8 or sam_size != "vit_h") and stage not in ("masks", "e2e"):
        # a run asking for the fast-mode models must not record float
        # numbers as if they were the fast mode's
        raise SystemExit("--rect_encode/--quant_int8/--sam_size only apply to "
                         "--stage masks|e2e")
    if profile and (stage != "e2e" or rect_encode or quant_int8 or sam_size != "vit_h"):
        raise SystemExit("--profile fast is an e2e sweep of the speed modes; use it "
                         "alone with --stage e2e")
    swin_camera = "--swin_camera" in argv
    camera_bf16 = "--camera_bf16" in argv
    # fused is the default; the negative flag is for the A/B against the
    # plain branch only
    no_camera_fused = "--no_camera_fused" in argv
    if (swin_camera or camera_bf16 or no_camera_fused) and stage != "fusion_train":
        raise SystemExit("--swin_camera/--camera_bf16/--no_camera_fused only apply to "
                         "--stage fusion_train")
    if no_camera_fused and not swin_camera:
        raise SystemExit("--no_camera_fused requires --swin_camera")

    kwargs = {}
    if stage in ("masks", "e2e") and not profile:
        kwargs = dict(rect_encode=rect_encode, quant_int8=quant_int8,
                      quant_static=quant_static, sam_size=sam_size)
    elif stage == "fusion_train":
        kwargs = dict(camera_backbone="swin_t" if swin_camera else "conv",
                      camera_bf16=camera_bf16, camera_fused=not no_camera_fused)
    return {"stage": stage, "profile": profile, "kwargs": kwargs}


def run(call: dict) -> dict:
    """Run the parsed bench call; returns its result line."""
    from cm3d_tpu_torch import benchmarks

    stage, kwargs = call["stage"], call["kwargs"]
    if stage == "masks":
        return benchmarks.bench_mask_stage(**kwargs)
    if stage == "e2e":
        if call["profile"] == "fast":
            return benchmarks.bench_e2e_fast_profile()
        return benchmarks.bench_e2e(**kwargs)
    if stage == "train":
        return benchmarks.bench_train()
    if stage == "fusion_train":
        return benchmarks.bench_fusion_train(**kwargs)
    line = benchmarks.bench_lift()
    if stage is None:
        # the default: the lift headline, which is not the end-to-end number
        line["note"] = ("lift stage only; the fused images->masks->boxes "
                        "number is --stage e2e")
    return line


def main(argv=None) -> None:
    call = parse(sys.argv[1:] if argv is None else list(argv))
    with _stdout_to_stderr():
        line = run(call)
    _emit(line)


if __name__ == "__main__":
    main()
