"""Token strings and normalization constants of the data contract (copied
from `aigv_assessor_tpu/data/constants.py`, which the port cannot import
without jax)."""

IMG_CONTEXT_TOKEN = "<IMG_CONTEXT>"
IMG_START_TOKEN = "<img>"
IMG_END_TOKEN = "</img>"
QUAD_START_TOKEN = "<quad>"
QUAD_END_TOKEN = "</quad>"
REF_START_TOKEN = "<ref>"
REF_END_TOKEN = "</ref>"
BOX_START_TOKEN = "<box>"
BOX_END_TOKEN = "</box>"

SPECIAL_TOKENS = (
    IMG_START_TOKEN,
    IMG_END_TOKEN,
    IMG_CONTEXT_TOKEN,
    QUAD_START_TOKEN,
    QUAD_END_TOKEN,
    REF_START_TOKEN,
    REF_END_TOKEN,
    BOX_START_TOKEN,
    BOX_END_TOKEN,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.4814546, 0.4578275, 0.40821073)
CLIP_STD = (0.2686295, 0.2613025, 0.2757711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)

NORMALIZE_STATS = {
    "imagenet": (IMAGENET_MEAN, IMAGENET_STD),
    "clip": (CLIP_MEAN, CLIP_STD),
    "siglip": (SIGLIP_MEAN, SIGLIP_STD),
}

IGNORE_TOKEN_ID = -100

# quality word -> level of the stage-1 evaluation, checked in this order
QUALITY_LEVELS = {"bad": 1, "poor": 2, "fair": 3, "good": 4, "excellent": 5}
