"""Framework constants.

A copy of the JAX package's ``core/constants.py`` (the port imports nothing
from that package); its values are the reference's
``dataset_utils/enums.py`` (Enums class, :4-55): question-type taxonomy,
special tokens, sequence-length budget. Everything here is a *static* shape or vocab
fact — the whole framework compiles against these, so they are plain module
constants, never runtime config.
"""

from types import MappingProxyType

# ---------------------------------------------------------------------------
# Question-type taxonomy (reference enums.py:6-18; OK-VQA taxonomy, retained
# for API parity even though DAQUAR does not use it).
# ---------------------------------------------------------------------------
QUESTION_TYPES = MappingProxyType({
    "eight": "Plants and Animals",
    "nine": "Science and Technology",
    "four": "Sports and Recreation",
    "six": "Geography, History, Language and Culture",
    "two": "Brands, Companies and Products",
    "other": "Other",
    "one": "Vehicles and Transportation",
    "five": "Cooking and Food",
    "ten": "Weather and Climate",
    "seven": "People and Everyday life",
    "three": "Objects, Material and Clothing",
})

TOTAL_QUESTION_TYPES = len(QUESTION_TYPES)
QUESTION_IDS_TO_TYPE = MappingProxyType(dict(enumerate(QUESTION_TYPES)))
QUESTION_TYPE_TO_IDS = MappingProxyType(
    {q_type: idx for idx, q_type in enumerate(QUESTION_TYPES)}
)

# ---------------------------------------------------------------------------
# Special tokens (reference enums.py:45-48).
# ---------------------------------------------------------------------------
QUESTION_SPECIAL_TOKEN = "[Question]"
CONTEXT_SPECIAL_TOKEN = "[CONTEXT]"
QUESTION_TYPE_SPECIAL_TOKEN = "[QUESTION_TYPE]"
ANSWER_SPECIAL_TOKEN = "[Answer]"

# Question-type surface forms used as extra special tokens by the collate
# (reference resnet_vqa_daquar_dataset.py:125-129).
QUESTION_TYPE_TOKENS = tuple(
    qt.replace(" ", "_") for qt in QUESTION_TYPES.values()
)

# ---------------------------------------------------------------------------
# Sequence-length budget (reference enums.py:50-55 and collate call sites:
# encoder question max_length=16 at resnet_vqa_daquar_dataset.py:192,
# decoder question / answers max_length=MAX_LEN=20 at :187,:195).
# Static shapes are load-bearing on TPU: every batch compiles to the same
# XLA program.
# ---------------------------------------------------------------------------
MAX_LEN = 20
QUESTION_MAX_LEN = 16
ANSWERS_PER_QUESTION = 10
NUM_BEAMS = 3
PAD_TOKEN_ID = 0
EOS_TOKEN_ID = 1

# ---------------------------------------------------------------------------
# Model geometry (reference multi_head_vision_text_attn.py:7-24 and the
# HF checkpoints the reference loads: t5-base, vit-base-patch16-224-in21k,
# roberta-base, torchvision resnet18/34/50 + frcnn-resnet50-fpn).
# ---------------------------------------------------------------------------
HIDDEN_SIZE = 768          # shared text/vision fusion width
SGA_NUM_HEADS = 8          # MULTI_HEAD (multi_head_vision_text_attn.py:10)
SGA_FF_SIZE = 768          # FF_SIZE
SGA_DROPOUT = 0.1
SGA_DEFAULT_BLOCKS = 3     # num_attention_blocks (resnet_vqa_model.py:38)

CNN_IMAGE_SIZE = 256       # CNN-family input (collate resizing 256x256)
VIT_IMAGE_SIZE = 224       # ViT-family input (HF image processor)
CNN_VISION_TOKENS = 64     # 8x8 feature map of a stride-32 resnet at 256^2
FPN_VISION_TOKENS = 16     # 4x4 'pool' FPN level at 256^2

# T5 vocab: 32100 real pieces padded to 32128 embedding rows. The reference
# adds 3 + 11 special tokens WITHOUT resizing embeddings (the new ids land in
# the 32100..32127 padding range — resnet_vqa_daquar_dataset.py:121-129 and
# no resize_token_embeddings call anywhere), so the framework pins them there.
T5_VOCAB_SIZE = 32128
T5_FIRST_EXTRA_ID = 32100

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# the in21k ViT image processor's normalization (vit_vqa_daquar_dataset.py:108)
VIT_IMAGE_MEAN = (0.5, 0.5, 0.5)
VIT_IMAGE_STD = (0.5, 0.5, 0.5)

# Named preprocessing strategies (reference enums.py:32-43 registers
# albumentations transforms; here they are names resolved by
# data/preprocessing.py into pure-numpy/XLA ops).
TRANSFORM_STRATEGIES = (
    "smallestMaxSize",
    "ShiftScaleRotate",
    "RandomCrop",
    "RGBShift",
    "RandomBrightnessContrast",
    "MultiplicativeNoise",
    "Normalize",
    "HueSaturationValue",
    "ToTensorV2",
)

INTERPOLATION_STRATEGIES = (
    "bilinear_interpolation",
    "lanczos_interpolation",
    "bicubic_interpolation",
)
