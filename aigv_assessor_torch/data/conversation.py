"""Chat prompt templates (a copy of `aigv_assessor_tpu/data/conversation.py`,
which imports nothing of JAX but lives in the JAX package, so the port keeps
its own).

The templates the pipeline selects: `internlm2-chat`, `phi3-chat`,
`Hermes-2` (all in the MPT separator style) and `internvl_zh`. In the MPT
style the prompt is

    <system_template with system_message><sep>
    <role0><message><sep><role1><message><sep>...

and an open assistant turn ends with the bare role string.
"""


from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Conversation:
    name: str
    system_template: str = "{system_message}"
    system_message: str = ""
    roles: Tuple[str, str] = ("USER", "ASSISTANT")
    sep: str = "\n"
    # second separator for two-separator styles (reference `sep2`, used by
    # ADD_COLON_TWO and INTERNVL_ZH templates, `conversation.py:71-79,229-236`)
    sep2: Optional[str] = None
    sep_style: str = "mpt"  # 'mpt' | 'add_colon_two' | 'internvl_zh'
    stop_token_ids: Optional[List[int]] = None
    messages: List[Tuple[str, Optional[str]]] = dataclasses.field(default_factory=list)

    def get_prompt(self) -> str:
        system = self.system_template.format(system_message=self.system_message)
        if self.sep_style == "add_colon_two":
            # reference `conversation.py:71-79`
            seps = [self.sep, self.sep2]
            ret = system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message is not None:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == "internvl_zh":
            # reference `conversation.py:229-236` (seps swapped vs colon_two)
            seps = [self.sep2, self.sep]
            ret = self.system_message + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message is not None:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        ret = system + self.sep
        for role, message in self.messages:
            if message is not None:
                ret += role + message + self.sep
            else:
                ret += role
        return ret

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append((role, message))

    def copy(self) -> "Conversation":
        return Conversation(
            name=self.name,
            system_template=self.system_template,
            system_message=self.system_message,
            roles=self.roles,
            sep=self.sep,
            sep2=self.sep2,
            sep_style=self.sep_style,
            stop_token_ids=(
                list(self.stop_token_ids) if self.stop_token_ids else None
            ),
            messages=[],
        )


_TEMPLATES: Dict[str, Conversation] = {}


def register_conv_template(template: Conversation, override: bool = False) -> None:
    if not override and template.name in _TEMPLATES:
        raise ValueError(f"template {template.name} already registered")
    _TEMPLATES[template.name] = template


def get_conv_template(name: str) -> Conversation:
    return _TEMPLATES[name].copy()


# `internlm2-chat` (reference `conversation.py:371-387`); the system message
# is part of the data contract (tokenized into every sample).
register_conv_template(
    Conversation(
        name="internlm2-chat",
        system_template="<|im_start|>system\n{system_message}",
        system_message=(
            "你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，"
            "英文名叫InternVL, 是一个有用无害的人工智能助手。"
        ),
        roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
        sep="<|im_end|>",
        stop_token_ids=[2, 92543, 92542],
    )
)

# `phi3-chat` (reference `conversation.py:390-405`)
register_conv_template(
    Conversation(
        name="phi3-chat",
        system_template="<|system|>\n{system_message}",
        system_message=(
            "你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，"
            "英文名叫InternVL, 是一个有用无害的人工智能助手。"
        ),
        roles=("<|user|>\n", "<|assistant|>\n"),
        sep="<|end|>",
        stop_token_ids=[2, 32000, 32007],
    )
)

# `internvl_zh` (reference `conversation.py:334-343`): the 4th registered
# template; any entry script run with it falls through to the plain
# `preprocess` masker (`stage1_train.py:465-466`).
register_conv_template(
    Conversation(
        name="internvl_zh",
        system_template="",
        system_message="",
        roles=("<human>", "<bot>"),
        sep="</s>",
        sep2=" ",
        sep_style="internvl_zh",
    )
)

# `Hermes-2` (reference `conversation.py:238-247`, MPT style)
register_conv_template(
    Conversation(
        name="Hermes-2",
        system_template="<|im_start|>system\n{system_message}",
        system_message=(
            "你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，"
            "英文名叫InternVL, 是一个有用无害的人工智能助手。"
        ),
        roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
        sep="<|im_end|>",
        stop_token_ids=[2, 6, 7, 8],
    )
)
