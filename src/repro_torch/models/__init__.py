from repro_torch.models.transformer import (DecoderLM, EncDecLM, HybridLM, MambaLM,
                                            active_param_count, build_model,
                                            param_count)

__all__ = ["DecoderLM", "EncDecLM", "HybridLM", "MambaLM", "active_param_count",
           "build_model", "param_count"]
