from .types import DataLoaderCfg, DataLoaderStageCfg, DatasetCfg, DatasetCfgCommon


def get_dataset(cfg, stage, view_sampler):
    """The dataset named by `cfg.name` (counterpart of
    latentsplat_tpu/dataset/__init__.py::get_dataset)."""
    from .co3d import DatasetCO3D
    from .re10k import DatasetRE10k
    from .synthetic import DatasetSynthetic

    datasets = {"re10k": DatasetRE10k, "co3d": DatasetCO3D, "synthetic": DatasetSynthetic}
    if cfg.name not in datasets:
        raise ValueError(f"unknown dataset {cfg.name!r}")
    return datasets[cfg.name](cfg, stage, view_sampler)


__all__ = ["DataLoaderCfg", "DataLoaderStageCfg", "DatasetCfg", "DatasetCfgCommon", "get_dataset"]
