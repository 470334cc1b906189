from repro_torch.models.transformer import (DecoderLM, MambaLM, build_model,
                                            param_count)

__all__ = ["DecoderLM", "MambaLM", "build_model", "param_count"]
