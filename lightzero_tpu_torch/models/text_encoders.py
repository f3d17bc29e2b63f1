"""Language-model observation encoders for text envs, the Jericho family
(``lightzero_tpu/models/text_encoders.py``, already host-side torch in the
JAX package; reference lzero/model/common.py):

- ``HFLanguageEncoder`` (reference ``HFLanguageRepresentationNetwork``,
  :478): a frozen HuggingFace encoder (BERT family) embeds the observation
  text; the [CLS] or mean-pooled hidden state is the embedding.
- ``QwenEncoder`` (reference ``QwenNetwork``, :367): a causal LM whose final
  hidden state is mean-pooled over the non-padding positions.

The frozen LM is an observation preprocessor: it emits fixed-size float
vectors that the policy's model consumes like any vector observation, and
the projection to the latent lives in the model. transformers is imported
where an encoder is built, never when this module is imported (the card's
machine has no transformers). Both classes load only weights found locally
(``local_files_only``): construction raises where none are, and
``available()`` says whether they are. ``tiny_random`` builds a random
one-layer BERT with ``_HashTokenizer`` and needs no files.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class _HashTokenizer:
    """Offline stand-in for an HF tokenizer: whitespace-split + stable hash
    into a fixed vocab. Lets the encoder stack run end-to-end in images
    with no tokenizer files (zero egress)."""

    def __init__(self, vocab_size: int, max_length: int):
        self.vocab_size = vocab_size
        self.max_length = max_length

    def __call__(self, texts: List[str], return_tensors: str = "pt",
                 padding: bool = True, truncation: bool = True,
                 max_length: Optional[int] = None):
        import torch

        max_length = max_length or self.max_length
        rows = []
        for t in texts:
            # ids 0/1 reserved for [PAD]/[CLS]
            ids = [1] + [2 + (hash(w) % (self.vocab_size - 2))
                         for w in t.lower().split()][: max_length - 1]
            rows.append(ids)
        T = max(len(r) for r in rows)
        input_ids = torch.zeros((len(rows), T), dtype=torch.long)
        mask = torch.zeros((len(rows), T), dtype=torch.long)
        for i, r in enumerate(rows):
            input_ids[i, : len(r)] = torch.tensor(r)
            mask[i, : len(r)] = 1
        return dict(input_ids=input_ids, attention_mask=mask)


class HFLanguageEncoder:
    """Frozen HF encoder → (B, hidden) numpy embeddings (common.py:478)."""

    def __init__(self, model_name: str = "bert-base-uncased", max_length: int = 512,
                 pooling: str = "cls"):
        import torch
        from transformers import AutoModel, AutoTokenizer

        self._torch = torch
        self.tokenizer = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
        self.model = AutoModel.from_pretrained(model_name, local_files_only=True)
        self.model.eval()
        self.max_length = max_length
        self.pooling = pooling
        self.hidden_size = int(self.model.config.hidden_size)

    @classmethod
    def tiny_random(cls, hidden_size: int = 32, vocab_size: int = 512,
                    max_length: int = 64, pooling: str = "cls") -> "HFLanguageEncoder":
        """Random-weight BERT built from a config (NO downloaded weights or
        tokenizer files): exercises the full embed→pool→project path
        offline. For real runs, place HF weights locally and use
        __init__."""
        import torch
        from transformers import BertConfig, BertModel

        self = cls.__new__(cls)
        self._torch = torch
        self.model = BertModel(BertConfig(
            vocab_size=vocab_size, hidden_size=hidden_size,
            num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=4 * hidden_size,
            max_position_embeddings=max_length,
        ))
        self.model.eval()
        self.tokenizer = _HashTokenizer(vocab_size, max_length)
        self.max_length = max_length
        self.pooling = pooling
        self.hidden_size = hidden_size
        return self

    @staticmethod
    def available(model_name: str = "bert-base-uncased") -> bool:
        try:
            from transformers import AutoConfig

            AutoConfig.from_pretrained(model_name, local_files_only=True)
            return True
        except Exception:
            return False

    def encode(self, texts: List[str]) -> np.ndarray:
        torch = self._torch
        with torch.no_grad():
            enc = self.tokenizer(
                texts, return_tensors="pt", padding=True, truncation=True,
                max_length=self.max_length,
            )
            out = self.model(**enc).last_hidden_state  # (B, T, H)
            if self.pooling == "cls":
                emb = out[:, 0]
            else:
                mask = enc["attention_mask"].unsqueeze(-1).float()
                emb = (out * mask).sum(1) / mask.sum(1).clamp(min=1)
            return emb.float().numpy()


class QwenEncoder(HFLanguageEncoder):
    """Causal-LM variant with mean pooling over non-padding positions
    (reference QwenNetwork, common.py:367-476)."""

    def __init__(self, model_name: str = "Qwen/Qwen2.5-0.5B", max_length: int = 512):
        import torch
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self._torch = torch
        self.tokenizer = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
        self.model = AutoModelForCausalLM.from_pretrained(
            model_name, local_files_only=True, output_hidden_states=True
        )
        self.model.eval()
        self.max_length = max_length
        self.pooling = "mean"
        self.hidden_size = int(self.model.config.hidden_size)

    def encode(self, texts: List[str]) -> np.ndarray:
        torch = self._torch
        with torch.no_grad():
            enc = self.tokenizer(
                texts, return_tensors="pt", padding=True, truncation=True,
                max_length=self.max_length,
            )
            out = self.model(**enc).hidden_states[-1]
            mask = enc["attention_mask"].unsqueeze(-1).float()
            emb = (out * mask).sum(1) / mask.sum(1).clamp(min=1)
            return emb.float().numpy()
