from repro_torch.configs.registry import (ARCHITECTURES, DSC_CONFIGS,
                                          DSCRunConfig, get_arch,
                                          get_dsc_config, reduced_config)

__all__ = ["ARCHITECTURES", "DSC_CONFIGS", "DSCRunConfig", "get_arch",
           "get_dsc_config", "reduced_config"]
