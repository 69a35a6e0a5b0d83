from repro_torch.configs.registry import (  # noqa: F401
    EncoderConfig, MLAConfig, MoEConfig, ModelConfig, RGLRUConfig, SSMConfig,
    get_config, list_configs, reduced, register,
)
