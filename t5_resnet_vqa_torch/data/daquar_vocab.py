"""Vendored DAQUAR answer vocabulary for metric-coverage auditing.

A copy of the JAX package's ``data/daquar_vocab.py`` (the port imports
nothing from that package). The reference trains against a
shipped-but-not-committed answer-space file
(``answer_spaces_single_word_threshold_5_without_O.txt``, 170 classes after
<5-occurrence filtering) built from the DAQUAR dataset (Malinowski & Fritz
2014, NYU-Depth-v2 indoor scenes). Neither the dataset nor that file is
available offline, so this module vendors a RECONSTRUCTION of that
vocabulary: the DAQUAR answer distribution is dominated by indoor object
classes (NYU-Depth-v2 label set), colors, and small counts, all normalized
space->underscore (the reference's Annotation rule).

Purpose (``tests/test_torch_daquar_vocab.py``):
  * audit that ``eval/mini_wordnet.py`` covers every answer word the WUPS
    metric will score — no silent OOV-scores-0 inside the answer space;
  * assert ``HashTokenizer`` id-assignment is injective over the realistic
    question+answer vocabulary (a collision would silently merge tokens).

This list is deliberately a superset of any single threshold-5 cut: auditing
against more words than the real 170 only strengthens the guarantee.
"""

from __future__ import annotations

from typing import List

# Indoor-scene object answers (NYU-Depth-v2 classes as they appear in DAQUAR
# answers, space->underscore normalized), colors, and spelled/digit counts.
ANSWER_WORDS: List[str] = [
    # --- furniture / large objects
    "table", "desk", "chair", "armchair", "stool", "bench", "sofa", "couch",
    "ottoman", "bed", "mattress", "headboard", "crib", "cabinet", "wardrobe",
    "closet", "dresser", "nightstand", "shelf", "shelves", "bookshelf",
    "bookcase", "drawer", "counter", "countertop", "cupboard", "sideboard",
    "rocking_chair", "office_chair", "coffee_table", "dining_table",
    "night_stand", "chest_of_drawers", "bunk_bed", "file_cabinet",
    # --- lighting
    "lamp", "chandelier", "light", "candle", "candlestick", "floor_lamp",
    "table_lamp", "desk_lamp", "lamp_shade", "night_light",
    # --- appliances / machines
    "refrigerator", "fridge", "stove", "oven", "microwave", "toaster",
    "blender", "dishwasher", "washing_machine", "dryer", "machine", "heater",
    "radiator", "fan", "ceiling_fan", "air_conditioner", "vacuum_cleaner",
    "coffee_machine", "coffee_maker", "sewing_machine", "treadmill",
    "exercise_equipment", "iron", "ironing_board", "hair_dryer",
    # --- electronics
    "television", "tv", "computer", "laptop", "monitor", "keyboard", "mouse",
    "printer", "scanner", "projector", "screen", "speaker", "stereo",
    "radio", "telephone", "phone", "remote_control", "remote", "switch",
    "light_switch", "outlet", "charger", "clock", "alarm_clock",
    "wall_clock", "cable", "wire", "dvd_player", "cd_player", "camera",
    "video_game", "game_console", "headphones", "modem", "router",
    # --- containers / vessels / kitchenware
    "bottle", "jar", "cup", "mug", "glass", "bowl", "pot", "pan", "kettle",
    "vase", "box", "bag", "basket", "suitcase", "backpack", "purse",
    "trash_can", "garbage_bin", "garbage_can", "waste_basket", "bin",
    "bucket", "tray", "sink", "bathtub", "toilet", "faucet", "plate",
    "dish", "knife", "fork", "spoon", "chopstick", "cutting_board",
    "dish_rack", "laundry_basket", "hamper", "flower_pot", "water_bottle",
    "wine_bottle", "container", "jug", "pitcher", "teapot", "saucer",
    # --- textiles / coverings / clothing
    "curtain", "curtains", "blinds", "shower_curtain", "towel", "napkin",
    "tissue", "toilet_paper", "paper_towel", "blanket", "sheet", "sheets",
    "bedsheets", "pillow", "cushion", "carpet", "rug", "mat", "bath_mat",
    "doormat", "tablecloth", "clothes", "clothing", "jacket", "coat",
    "shirt", "pants", "hat", "scarf", "shoe", "shoes", "slippers",
    "sock", "socks", "tie", "belt", "cloth", "fabric", "apron",
    # --- structure / surfaces / fixtures
    "door", "doorknob", "window", "windowsill", "wall", "floor", "ceiling",
    "ladder", "stairs", "railing", "rack", "towel_rack", "hook", "hanger",
    "frame", "mirror", "shower", "pipe", "vent", "fireplace", "mantle",
    "column", "beam", "tile", "tiles", "board", "bulletin_board",
    "whiteboard", "blackboard", "corkboard", "partition", "banister",
    # --- paper / pictures / writing / media
    "book", "books", "notebook", "magazine", "newspaper", "paper", "papers",
    "poster", "calendar", "map", "picture", "photo", "photograph",
    "painting", "pen", "pencil", "marker", "folder", "file", "envelope",
    "card", "cards", "document", "letter", "sticker",
    # --- decorations / misc objects
    "decoration", "ornament", "doll", "toy", "toys", "teddy_bear",
    "stuffed_animal", "ball", "guitar", "piano", "drum", "umbrella",
    "bicycle", "bike", "soap", "soap_dish", "shampoo", "brush",
    "toothbrush", "toothpaste", "sponge", "comb", "perfume", "lotion",
    "medicine", "scissors", "tape", "glue", "stapler", "key", "keys",
    "wallet", "glasses", "sunglasses", "watch", "jewelry", "globe",
    "trophy", "statue", "figurine", "basket_ball", "football",
    # --- living / food
    "plant", "plants", "flower", "flowers", "tree", "person", "man",
    "woman", "child", "dog", "cat", "fish", "bird", "food", "bread",
    "cake", "fruit", "fruits", "apple", "banana", "orange", "lemon",
    "tomato", "vegetable", "vegetables", "egg", "cereal", "milk", "juice",
    "water", "wine", "coffee", "tea", "sugar", "salt",
    # --- colors
    "red", "blue", "green", "yellow", "brown", "pink", "purple", "violet",
    "white", "black", "gray", "grey", "beige", "tan", "silver", "gold",
    "transparent", "colorful", "dark", "bright",
    # --- counts (digit and spelled forms both appear in DAQUAR answers)
    "0", "1", "2", "3", "4", "5", "6", "7", "8", "9", "10",
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve",
]

# Question-side vocabulary: DAQUAR question templates are narrow ("what is on
# the table", "how many chairs are there", ...). Used for the HashTokenizer
# injectivity audit together with ANSWER_WORDS.
QUESTION_WORDS: List[str] = [
    "what", "is", "are", "on", "in", "the", "a", "an", "of", "how", "many",
    "there", "color", "colour", "object", "objects", "item", "items",
    "thing", "things", "behind", "front", "next", "to", "left", "right",
    "side", "above", "below", "under", "beneath", "near", "around",
    "between", "at", "and", "or", "which", "where", "who", "room",
    "picture", "image", "photo", "scene", "largest", "biggest", "smallest",
    "located", "found", "placed", "kept", "hanging", "standing", "lying",
    "sitting", "leaning", "top", "bottom", "middle", "center", "corner",
    "wall", "floor", "it", "that", "this", "these", "those",
]


def vocabulary() -> List[str]:
    """All distinct audit words (answers + question tokens)."""
    return sorted(set(ANSWER_WORDS) | set(QUESTION_WORDS))
