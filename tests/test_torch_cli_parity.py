"""The port's command line against the JAX package's, command by command.

For each of the nine commands and each of six command lines, both packages'
`build_parser().parse_args` and config builders give the same resolved
`AvsyncConfig`, field for field, but for the three kernel flags, which name
implementations and which the port sets per command
(`model.use_pallas_gru`, `model.fused_conv_pool`, `audio.use_pallas`). The
lines cover the defaults, a `--config` file whose seed, checkpoint directory,
quick_test, log directory, batch sizes, detector and audio fields and
compute dtype are not the defaults (the command line's `--seed 42`,
`--checkpoint_dir ./checkpoints` and `--quick_test` win over it, as in the
JAX CLI), `--model_family tf` with and without it, bf16 with the TF family,
and an explicit `--seed` over the file. Each subparser takes the JAX one's
options but for the exceptions named below. On the TF lines, the model each
package's family switch builds computes in float32, whatever the dtype.
"""

import dataclasses

import numpy as np
import pytest
import torch

import avsync.cli as jax_cli
from avsync.config import AudioConfig as JaxAudioConfig
from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DataConfig as JaxDataConfig
from avsync.config import DetectorConfig as JaxDetectorConfig
from avsync.config import ModelConfig as JaxModelConfig
from avsync.config import TrainConfig as JaxTrainConfig
from avsync.models import make_lipnet as jax_make_lipnet
from avsync_torch import cli
from avsync_torch.models import make_lipnet

# each command with its required arguments, and the port's builder of its config
COMMANDS = {
    "train": ([], cli._config_from_args),
    "test": (["--checkpoint", "c.pth"], cli._config_from_args),
    "infer": (["clip.mpg", "--checkpoint", "c.pth"], lambda a: cli._config_from_args(a, ())),
    "quantize": (["--checkpoint", "c.pth"], cli._config_from_args),
    "export": (["--checkpoint", "c.pth"], cli._serving_config),
    "serve": (["--checkpoint", "c.pth"], cli._serving_config),
    "misalign-train": ([], cli._detector_config_from_args),
    "misalign-eval": ([], cli._detector_config_from_args),
    "misalign-demo": ([], cli._detector_config_from_args),
}
CONFIG = "{config}"  # the file's path, filled in per test
LINES = {
    "none": [],
    "config": ["--config", CONFIG],
    "tf": ["--model_family", "tf"],
    "config_tf": ["--config", CONFIG, "--model_family", "tf"],
    "bf16_tf": ["--compute_dtype", "bfloat16", "--model_family", "tf"],
    "config_seed": ["--config", CONFIG, "--seed", "3"],
}
KERNEL_FLAGS = {("model", "use_pallas_gru"), ("model", "fused_conv_pool"),
                ("audio", "use_pallas")}
# options of one package's subparser that the other's lacks, with the reason
EXCEPTIONS = {
    (None, "--device"): "the port's own: the torch device a command runs on",
    ("export", "--platforms"): "the JAX package's XLA lowering targets",
    ("infer", "--roi_mode"): "the mouth ROI of a native clip (the JAX infer takes it "
                             "from --config only)",
    ("infer", "--roi_host"): "the same, for the ROI crop on the host",
    ("infer", "--no-roi_host"): "the same, for the ROI crop on the host",
    ("infer", "--distributed"): "refused with the JAX package's message, as on every "
                                "command but train",
}


@pytest.fixture(scope="module")
def config_file(tmp_path_factory):
    """A config whose command-line-facing fields are not the defaults."""
    path = tmp_path_factory.mktemp("parity") / "cfg.json"
    path.write_text(JaxConfig(
        data=JaxDataConfig(batch_size=4, img_height=20, img_width=40, device_cache="off"),
        model=JaxModelConfig(hidden_dim=16, compute_dtype="bfloat16"),
        audio=JaxAudioConfig(sample_rate=8000, n_mfcc=13),
        detector=JaxDetectorConfig(batch_size=16, hidden_dim=64, max_shift_frames=9, epochs=3,
                                   lr=5e-4),
        train=JaxTrainConfig(seed=7, checkpoint_dir="ck_from_file", quick_test=True,
                             log_dir="logs_from_file", epochs=5)).to_json())
    return str(path)


def _argv(command, line, config_file):
    extra, _ = COMMANDS[command]
    return [command, *extra, *(config_file if a == CONFIG else a for a in LINES[line])]


def _fields(cfg):
    return {(section, name): value
            for section, fields in dataclasses.asdict(cfg).items()
            for name, value in fields.items()}


def _resolved(command, line, config_file):
    argv = _argv(command, line, config_file)
    ours = COMMANDS[command][1](cli.build_parser().parse_args(argv))
    theirs = jax_cli._config_from_args(jax_cli.build_parser().parse_args(argv))
    return ours, theirs


@pytest.mark.parametrize("line", list(LINES))
@pytest.mark.parametrize("command", list(COMMANDS))
def test_resolved_config_equals_the_jax_cli(command, line, config_file):
    ours, theirs = _resolved(command, line, config_file)
    got, want = _fields(ours), _fields(theirs)
    assert set(got) == set(want)
    differ = {k: (got[k], want[k]) for k in got if got[k] != want[k] and k not in KERNEL_FLAGS}
    assert not differ
    # the JAX CLI's precedence over a config file
    seed = 3 if line == "config_seed" else 42
    assert ours.train.seed == seed
    if command == "train":
        assert (ours.train.checkpoint_dir, ours.train.quick_test) == ("./checkpoints", False)
    if "config" in line:
        assert ours.model.compute_dtype == "bfloat16" and ours.data.batch_size == 4
        assert ours.train.log_dir == ("logs" if command == "misalign-train" else
                                      "logs_from_file")
    else:
        assert ours.train.log_dir == "logs"


@pytest.mark.parametrize("command", list(COMMANDS))
def test_each_subparser_takes_the_jax_options(command):
    def options(parser):
        sub = parser._subparsers._group_actions[0].choices[command]
        return {s for a in sub._actions for s in a.option_strings}

    ours, theirs = options(cli.build_parser()), options(jax_cli.build_parser())
    excepted = {opt for (cmd, opt) in EXCEPTIONS if cmd in (None, command)}
    assert ours ^ theirs == excepted & (ours | theirs)


@pytest.mark.parametrize("line", ["tf", "config_tf", "bf16_tf"])
@pytest.mark.parametrize("command", list(COMMANDS))
def test_tf_commands_build_a_float32_model(command, line, config_file):
    """The family switch of either package builds the TF stack in float32:
    the JAX one drops the config's compute dtype, and so does the port's
    (here at a small width with the resolved config's dtype kept), whose
    float32 model takes a bf16 cached batch as float32."""
    ours, theirs = _resolved(command, line, config_file)
    assert ours.model.family == theirs.model.family == "tf"
    assert jax_make_lipnet(theirs.model).cfg.compute_dtype == "float32"
    small = dataclasses.replace(ours.model, hidden_dim=4, conv_channels=(2, 2, 3))
    model = make_lipnet(small, (8, 16), generator=torch.Generator().manual_seed(0)).eval()
    assert model.compute_dtype is None and model.cfg.compute_dtype == "float32"
    x = torch.from_numpy(np.random.default_rng(0).random((1, 3, 8, 16, 1), np.float32))
    with torch.inference_mode():
        out = model(x.to(torch.bfloat16))
        assert out.dtype == torch.float32
        assert torch.equal(out, model(x.to(torch.bfloat16).float()))


@pytest.mark.parametrize("batch_sizes", ["0,2", "a,b"])
def test_export_refuses_bad_batch_sizes_as_the_jax_cli(batch_sizes, tmp_path, capsys):
    """`export --batch_sizes` that does not parse, or has an entry <= 0:
    the message on stdout and exit code 2, before any checkpoint is read
    (`avsync/cli.py:636-645`)."""
    argv = ["export", "--checkpoint", str(tmp_path / "missing.pth"), "--out",
            str(tmp_path / "a.zip"), "--batch_sizes", batch_sizes]
    codes, outs = [], []
    for m in (jax_cli.main, cli.main):
        codes.append(m(argv))
        captured = capsys.readouterr()
        outs.append(captured.out)
        assert captured.err == ""
    assert codes == [2, 2]
    assert outs[1] == outs[0] and "--batch_sizes" in outs[0] and repr(batch_sizes) in outs[0]
