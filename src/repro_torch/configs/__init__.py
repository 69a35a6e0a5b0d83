from repro_torch.configs.registry import (  # noqa: F401
    ModelConfig, get_config, list_configs, reduced, register,
)
