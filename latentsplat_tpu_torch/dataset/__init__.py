from .types import DataLoaderCfg, DataLoaderStageCfg, DatasetCfg, DatasetCfgCommon


def get_dataset(cfg, stage, view_sampler):
    """The dataset named by `cfg.name` (counterpart of
    latentsplat_tpu/dataset/__init__.py::get_dataset)."""
    if cfg.name == "synthetic":
        from .synthetic import DatasetSynthetic

        return DatasetSynthetic(cfg, stage, view_sampler)
    if cfg.name in ("re10k", "co3d"):
        raise NotImplementedError(
            f"the {cfg.name} dataset is not ported yet (ROADMAP queue 1 item 9: it needs a JPEG "
            "decoder and a crop shim that do not use PIL); use dataset.name=synthetic"
        )
    raise ValueError(f"unknown dataset {cfg.name!r}")


__all__ = ["DataLoaderCfg", "DataLoaderStageCfg", "DatasetCfg", "DatasetCfgCommon", "get_dataset"]
