from repro_torch.models.transformer import (DecoderLM, HybridLM, MambaLM, build_model,
                                            param_count)

__all__ = ["DecoderLM", "HybridLM", "MambaLM", "build_model", "param_count"]
