from repro_torch.models.transformer import (DecoderLM, HybridLM, MambaLM,
                                            active_param_count, build_model,
                                            param_count)

__all__ = ["DecoderLM", "HybridLM", "MambaLM", "active_param_count", "build_model",
           "param_count"]
