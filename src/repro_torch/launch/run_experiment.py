"""Spec loading shared by the port's drivers — the part of
`repro.launch.run_experiment` that serving needs (`load_spec`,
`DEFAULT_RESULTS`). The training driver itself comes with the training
slice; until then `python -m repro.launch.run_experiment` trains and
writes checkpoints that `repro_torch.launch.serve_gcn` restores."""
from __future__ import annotations

import pathlib

from repro_torch.core.experiment import (ExperimentSpec, apply_overrides,
                                         parse_set_items, preset, validate)

# cwd-relative so non-editable installs don't write into site-packages
DEFAULT_RESULTS = pathlib.Path("results") / "experiments"


def load_spec(args) -> ExperimentSpec:
    """--preset or --spec, then every --set override, validated."""
    if args.preset and args.spec:
        raise SystemExit("pass --preset OR --spec, not both")
    if args.preset:
        spec = preset(args.preset)
    elif args.spec:
        spec = ExperimentSpec.from_json(
            pathlib.Path(args.spec).read_text())
    else:
        raise SystemExit("one of --preset/--spec is required")
    try:
        apply_overrides(spec, parse_set_items(args.set))
    except (ValueError, KeyError) as e:
        # KeyError: unknown --set path; ValueError: malformed item
        raise SystemExit(str(e).strip('"'))
    return validate(spec)
