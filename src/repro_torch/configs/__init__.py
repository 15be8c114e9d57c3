from repro_torch.configs.registry import (DSC_CONFIGS, DSCRunConfig,
                                          get_dsc_config)

__all__ = ["DSC_CONFIGS", "DSCRunConfig", "get_dsc_config"]
