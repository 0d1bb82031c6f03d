"""Tokenizer wrapper: a jax-free copy of `aigv_assessor_tpu/data/tokenizer.py`
(`tests/test_torch_cli.py` holds its ids against the original's).

Replaces the reference's sentencepiece-backed `InternLM2Tokenizer` with the
HF `tokenizers` Rust library. Loads either a `tokenizer.json` (the
fast-tokenizer serialization InternVL2 / InternLM2 checkpoints ship), a
directory holding one, or a sentencepiece `tokenizer.model` (converted once
through transformers' converter), and applies the 9 special tokens the
training entry points add (`stage1_train.py:791-799`): <img>, </img>,
<IMG_CONTEXT>, <quad>, </quad>, <ref>, </ref>, <box>, </box>. Padding follows
the InternLM2 convention pad = eos = '</s>'.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from tokenizers import AddedToken, Tokenizer

from aigv_assessor_torch.data.constants import IMG_CONTEXT_TOKEN, SPECIAL_TOKENS


def _convert_sentencepiece(spm_path: str) -> Tokenizer:
    """sentencepiece .model -> tokenizers backend via transformers' converter
    (replaces the reference's C++ sentencepiece dependency,
    `tokenization_internlm2.py:22`)."""
    try:
        from transformers import LlamaTokenizerFast

        tk = LlamaTokenizerFast(vocab_file=spm_path, legacy=False)
        return tk.backend_tokenizer
    except Exception as e:  # pragma: no cover
        raise RuntimeError(
            f"failed to convert sentencepiece model {spm_path}: {e}"
        ) from e


class AIGVTokenizer:
    def __init__(
        self,
        tokenizer: Tokenizer,
        bos_token: str = "<s>",
        eos_token: str = "</s>",
        unk_token: str = "<unk>",
        model_max_length: int = 4096,
        add_bos: bool = True,
    ):
        self._tk = tokenizer
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.unk_token = unk_token
        self.pad_token = eos_token  # InternLM2: pad == eos
        self.model_max_length = model_max_length
        self.add_bos = add_bos
        self.add_special_tokens(SPECIAL_TOKENS)

    # ----------------------------------------------------------- loading ---

    @classmethod
    def from_pretrained(cls, path: str, **kw) -> "AIGVTokenizer":
        """Load from a tokenizer.json (fast serialization) or, when a
        checkpoint ships only the sentencepiece `tokenizer.model` (the
        reference's slow InternLM2 tokenizer), convert it once through
        transformers' fast-tokenizer converter and use its Rust backend."""
        d = path if os.path.isdir(path) else os.path.dirname(path)
        json_path = path if path.endswith(".json") else os.path.join(d, "tokenizer.json")
        if os.path.exists(json_path):
            return cls(Tokenizer.from_file(json_path), **kw)
        spm_path = os.path.join(d, "tokenizer.model")
        if os.path.exists(spm_path):
            return cls(_convert_sentencepiece(spm_path), **kw)
        raise FileNotFoundError(
            f"no tokenizer.json or tokenizer.model under {d}"
        )

    # ------------------------------------------------------------- vocab ---

    def add_special_tokens(self, tokens: Sequence[str]) -> int:
        return self._tk.add_special_tokens(
            [AddedToken(t, special=True, normalized=False) for t in tokens]
        )

    @property
    def vocab_size(self) -> int:
        return self._tk.get_vocab_size()

    def convert_tokens_to_ids(self, token: str) -> Optional[int]:
        return self._tk.token_to_id(token)

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._tk.token_to_id(self.bos_token)

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._tk.token_to_id(self.eos_token)

    @property
    def pad_token_id(self) -> Optional[int]:
        return self._tk.token_to_id(self.pad_token)

    @property
    def img_context_token_id(self) -> Optional[int]:
        return self._tk.token_to_id(IMG_CONTEXT_TOKEN)

    # ------------------------------------------------------------ encode ---

    def encode(self, text: str, add_bos: Optional[bool] = None) -> List[int]:
        """Token ids; a leading bos mirrors the reference slow tokenizer
        (`tokenization_internlm2.py` add_bos_token=True default)."""
        ids = self._tk.encode(text, add_special_tokens=False).ids
        add_bos = self.add_bos if add_bos is None else add_bos
        bid = self.bos_token_id
        if add_bos and bid is not None:
            ids = [bid] + ids
        return ids

    def __call__(self, text, padding=None, max_length=None, truncation=False):
        """Minimal HF-style call used by preprocessing: returns input_ids
        (list of lists)."""
        texts = [text] if isinstance(text, str) else list(text)
        out = []
        max_length = max_length or self.model_max_length
        for t in texts:
            ids = self.encode(t)
            if truncation and len(ids) > max_length:
                ids = ids[:max_length]
            if padding == "max_length":
                ids = ids + [self.pad_token_id] * (max_length - len(ids))
            out.append(ids)
        return {"input_ids": out}

    # ------------------------------------------------------------ decode ---

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        return self._tk.decode(list(int(i) for i in ids), skip_special_tokens=skip_special_tokens)

    def batch_decode(self, batch, skip_special_tokens: bool = False) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]


def build_test_tokenizer(model_max_length: int = 4096) -> AIGVTokenizer:
    """A small, self-contained BPE tokenizer for tests and smoke runs (the
    real InternLM2 vocab comes from a checkpoint's tokenizer.json)."""
    from tokenizers import models, pre_tokenizers, trainers, decoders

    tk = Tokenizer(models.BPE(unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = decoders.ByteLevel()
    corpus = [
        "The static quality of the video is excellent.",
        "The static quality of the video is good.",
        "The static quality of the video is fair.",
        "The static quality of the video is poor.",
        "The static quality of the video is bad.",
        "The temporal smoothness of the video is excellent bad poor fair good.",
        "How would you rate the static quality of this video?",
        "How would you rate the temporal smoothness of this video?",
        "Frame1: Frame2: Frame3: Frame4: Frame5: Frame6: Frame7: Frame8:",
        "Motion Feature:",
        "<|im_start|>system user assistant <|im_end|>",
        "你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，"
        "英文名叫InternVL, 是一个有用无害的人工智能助手。",
    ]
    trainer = trainers.BpeTrainer(
        vocab_size=2000,
        special_tokens=["<unk>", "<s>", "</s>", "<|im_start|>", "<|im_end|>"],
        show_progress=False,
    )
    tk.train_from_iterator(corpus, trainer)
    return AIGVTokenizer(tk, model_max_length=model_max_length)
