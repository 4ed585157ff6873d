"""What the benchmark takes from the program (`avsync_torch`): its
configuration tree, built from a configuration file, and nothing else.
The kinds import the program's entry points themselves."""

from __future__ import annotations

from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig


def program_config(cfg: dict, batch: int, seed: int) -> AvsyncConfig:
    """The program's config of configuration file `cfg`: its family,
    widths, compute dtype and kernel flags as the CLI on the card resolves
    them, the cell's batch and the run's seed."""
    model = ModelConfig(
        family=cfg["family"], hidden_dim=cfg["hidden_dim"], dropout_rate=cfg["dropout_rate"],
        conv_channels=tuple(cfg["conv_channels"]),
        conv_kernels=tuple(tuple(k) for k in cfg["conv_kernels"]),
        vocab_size=cfg["outputs"] if cfg["family"] != "tf" else ModelConfig.vocab_size,
        num_gru_layers=cfg.get("num_gru_layers", ModelConfig.num_gru_layers),
        compute_dtype=cfg["compute_dtype"], **cfg["program_flags"])
    data = DataConfig(img_height=cfg["img_height"], img_width=cfg["img_width"],
                      max_video_length=cfg["frames"], max_label_length=cfg["max_label_length"],
                      standardize_clips=bool(cfg.get("standardize_clips", False)),
                      batch_size=batch)
    train = TrainConfig(learning_rate=cfg["learning_rate"], grad_clip_norm=cfg["grad_clip_norm"],
                        seed=seed, remat=False)
    return AvsyncConfig(data=data, model=model, train=train)
