"""Jobs that tests/test_torch_mesh_train.py runs in spawned processes
(parallel/dryrun.spawn). Kept apart from the test module, which imports
JAX: a spawned process imports the module of the function it runs."""

from click.testing import CliRunner


def run_jobs(jobs) -> list:
    """Each (fn, args) of `jobs` in turn, in this process's group (every
    rank runs the same list): one spawned group serves several steps."""
    return [fn(*args) for fn, args in jobs]


def train_cli(argv, spec_meta) -> str:
    """The port's training CLI in this process's group, with the page
    role's spec replaced by `spec_meta`; returns its output."""
    from sbb_textline_detection_tpu_torch.models import registry
    from sbb_textline_detection_tpu_torch.training import cli

    registry.DEFAULT_SPECS["page"] = registry.ModelSpec.from_meta(spec_meta)
    res = CliRunner().invoke(cli.main, list(argv))
    if res.exit_code != 0:
        raise RuntimeError(f"exit {res.exit_code}: {res.output}") \
            from res.exception
    return res.output
