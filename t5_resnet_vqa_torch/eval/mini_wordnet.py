"""Vendored noun-hypernym taxonomy for WUPS scoring without the NLTK corpus.

The reference's WUPS metric (dataset_utils/wup_measure.py:46-58)
computes Wu-Palmer similarity over WordNet noun synsets. This zero-egress
image has no NLTK corpus, so round 1 silently degraded to exact-match scoring
— the real code path never ran. This module vendors a small WordNet-style
noun taxonomy covering the DAQUAR indoor-scene answer vocabulary (household
objects, colors, numbers) plus the classic dog/cat pair, and implements the
same Wu-Palmer depth math NLTK uses:

    wup(s1, s2) = 2 * depth(lcs) / (len1 + len2)

where ``lcs`` is the deepest common hypernym, ``depth`` counts nodes from the
root (root = 1, matching NLTK's ``max_depth() + 1``), and ``len_i`` is the
node-count distance from ``s_i`` up to the lcs plus ``depth(lcs)``. For
tree-shaped chains stored root-first that reduces to

    wup = 2 * L / (len(chain1) + len(chain2)),   L = common-prefix length.

Chains follow WordNet 3.0's actual hierarchy where known (e.g. dog/cat share
``carnivore`` at depth 12, giving the canonical 0.857), so scores are close
to — but not guaranteed identical with — real NLTK output. When the NLTK
corpus IS installed, eval/wups.py uses it instead of this module.

Provenance audit (round 4)
--------------------------
Every vocabulary word is classified by ``provenance(word)``:

  * ``wordnet-3.0-exact`` — all vendored chains for the word are verbatim
    WordNet 3.0 hypernym paths, hand-derived (the ``_EXACT`` set below:
    colors, digits/small integers, the core furniture subtree, dog/cat).
  * ``approximation``     — WordNet-STYLE chain placed by category; the
    true WordNet 3.0 path may differ in intermediate nodes or depth.
  * ``no-noun-synset``    — scored 0.0, matching the reference's
    empty-synsets rule.

Lemma aliases: WordNet looks words up through morphy, so plural forms
("shelves") and same-synset lemmas ("couch"/"sofa", "grey"/"gray",
"tv"/"television", "closet"/"wardrobe", "dresser"/"chest_of_drawers")
resolve to the SAME synset and score wup = 1.0 against each other. The
``_ALIASES`` table reproduces that — round 3 modeled these as parent/child
(≈0.94) which real NLTK never does.

Pair-exactness estimate (see ``exactness_stats``): a pair's score is
believed reference-exact when BOTH words are in ``_EXACT``. The round-5
subtree derivation (furniture tail, containers/vessels, white goods +
kitchen appliances, the computer/laptop path, timepieces, writing
implements, publications, musical instruments, playthings, floor covers,
bedclothes, core fauna/flora) grew the set from 53 to 140 words, a
second round-5 batch of single-noun-sense promotions (mirror, keyboard,
remote_control/remote, faucet, heater, tray, wallet, bathtub, wall_clock,
stapler, vacuum_cleaner) to 152, the round-5 polysemy audit (commode
chain) promoted toilet and demoted bedsheets (a false 1.0 alias claim:
"bedsheet" is not a WN3.0 lemma), and wave 6 promoted 16 more
enumerable-inventory words (mouse, fan, sink, pitcher, hamper,
laundry_basket, waste_basket, radiator, blind/blinds, curtain/curtains,
shower_curtain, paper_towel, newspaper, suitcase) — 167 words = 45.5%
of the 367 audited answer-space words and 20.7% of answer pairs (rounds
≤4: 14.4% / 2.1%); strict tier (no known unvendored secondary sense on
either side, see the polysemy caveat below): 125 words / 11.6% of pairs.
Wave 6 also closed five same-synset collisions among non-exact words —
paper ∈ newspaper.n.01 (was 0.059, is 1.0 — the largest divergence
found), screen ∈ blind.n.03 ("blind, screen"), cloth ∈ fabric.n.01
(now an alias), glasses → glass via morphy, suitcase ∈ bag.n.06 —
plus bowl's dish/ball/bowlful senses, cake ("cake, patty") ⊂ dish.n.02,
the food.n.01 substance-side chain, and two chain fixes (outlet =
wall_socket.n.01 ⊂ receptacle; paper_towel ⊂ towel.n.01).
No answer-frequency data exists in this zero-egress image, so no
frequency-weighted share is claimed; the categories covered exactly
(colors, counts, furniture, appliances, structure-adjacent objects) are
the DAQUAR answer distribution's documented bulk, nothing more specific.
Every non-exact answer word falls in one of three documented buckets —
machine-checkable via ``non_exact_reason(word)`` (tests pin that no
vocabulary word is unaccounted for; the audit tool verifies the
non-lemma bucket against real NLTK):
(a) multiple-inheritance synsets our tree model linearizes (person/man/
woman/child, fruits via produce+fruit, wheeled containers), (b) synsets
whose WordNet 3.0 hypernym we could not re-derive with certainty offline
(the honest residue — e.g. chandelier, candle, curtain, mattress, glass,
plate), (c) space->underscore answer normalizations that may not be
WordNet lemmas at all (garbage_bin, flower_pot, basket_ball, office_chair,
desk_lamp — the reference scores a non-lemma 0.0 via empty synsets, so a
vendored chain here is deliberately MORE generous than the reference).
Polysemy caveat (tightened by the round-5 audit): the reference maxes over
a word's ENTIRE noun-synset inventory — slang and technical senses
included — so the vendored max can underestimate real NLTK wherever a
secondary sense lands nearer another vocabulary word than the primary
chain does. The audit walked the exact set for exactly this failure mode:
every case found that crosses the 0.925 threshold (same-synset lemma
collisions like pot/stool/toilet in the commode synset, toy ⊂ dog via
toy_dog, board/table via the meals synset, bag/purse via handbag,
glass-vs-mirror via looking_glass, painting/picture, curtain-vs-blinds)
is now vendored via ``_EXTRA_SYNSETS``; some benign cases were re-verified
(White/Black person-senses tie the 0.875 color value; team senses tie
0.875 for five/nine). Every REMAINING known-unvendored sense is listed in
``KNOWN_UNVENDORED_SENSES`` (dog's cad/frank senses, cat's Caterpillar
tractor, pen's female-swan, gray's horse, ...); all of those lie in the
x0.1 downweighted regime, bounding their absolute error at ~0.02 per
pair — with ONE flagged exception: cup's prize-cup sense, whose hypernym
(trophy vs vessel) is not re-derivable offline, so cup-vs-trophy may be
full-weight under real NLTK (registered, not vendored — vendoring a
guess risks the 10x-overestimate class wave 3 fixed). ``exactness_stats`` therefore reports two tiers: ``exact_pair_pct``
(both words' vendored chains verbatim) and ``strict_exact_pair_pct``
(additionally, neither word has a registered unvendored sense).
Full-inventory exactness beyond the registry is NOT claimed — verifying
it requires the real corpus, which is what tools/audit_wups_vs_nltk.py
measures on a corpus-ful host.

Quantifying the residue: ``tools/audit_wups_vs_nltk.py`` measures every
ordered vocabulary pair against REAL NLTK WordNet (on any corpus-ful
machine) and audits the ``_EXACT``/``_ALIASES``/``NO_NOUN_SYNSET`` claims
above; its verdict logic is stub-tested in tests/test_wups_audit.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

Chain = Tuple[str, ...]

# --- shared hypernym prefixes (root-first) --------------------------------
_PHYS = ("entity", "physical_entity")
_OBJ = _PHYS + ("object", "whole")
_ART = _OBJ + ("artifact",)
_INSTR = _ART + ("instrumentality",)
_FURN = _INSTR + ("furnishing", "furniture")
_SEAT = _FURN + ("seat",)
_DEV = _INSTR + ("device",)
_MACH = _DEV + ("machine",)
_APPL = _DEV + ("appliance", "home_appliance")
_KAPPL = _APPL + ("kitchen_appliance",)
_WGOODS = _APPL + ("white_goods",)
# equipment ⊂ instrumentality; electronic_equipment ⊂ equipment (WN3.0 —
# r5 fix: rounds ≤4 hung electronic_equipment under device)
_EQUIP = _INSTR + ("equipment",)
_ELEC = _EQUIP + ("electronic_equipment",)
_CONT = _INSTR + ("container",)
_VESSEL = _CONT + ("vessel",)
_UTENSIL = _INSTR + ("implement", "utensil")
_KUTENSIL = _UTENSIL + ("kitchen_utensil",)
# tableware ⊂ ware ⊂ article ⊂ artifact; cutlery.n.02 (lemmas "cutlery,
# eating_utensil") ⊂ tableware (r5 fix: rounds ≤4 hung eating utensils
# under instrumentality/implement, which WN3.0 does not)
_TABLEWARE = _ART + ("article", "ware", "tableware")
_CUTLERY = _TABLEWARE + ("cutlery",)
_COVER = _ART + ("covering",)
_CLOTH = _COVER + ("clothing",)
_DECOR = _ART + ("decoration",)
_LIVING = _OBJ + ("living_thing", "organism")
_ANIMAL = _LIVING + ("animal", "chordate", "vertebrate", "mammal", "placental")
_PLANT = _LIVING + ("plant", "vascular_plant")
_FOOD = _PHYS + ("matter", "solid", "food")
_FRUIT = _OBJ + ("natural_object", "plant_part", "plant_organ",
                 "reproductive_structure", "fruit", "edible_fruit")
_ABST = ("entity", "abstraction")
_COLOR = _ABST + ("attribute", "property", "visual_property", "color")
_CHROM = _COLOR + ("chromatic_color",)
_ACHROM = _COLOR + ("achromatic_color",)
_NUM = _ABST + ("measure", "definite_quantity", "number", "integer", "digit")
_STRUCT = _ART + ("structure",)
_SURFACE = _ART + ("surface",)
_PAPER = _ART + ("creation", "product", "work")
_WRITING = _INSTR + ("implement", "writing_implement")
_TOOL = _INSTR + ("implement", "tool")
_SUBST = _PHYS + ("matter", "substance")
_BEV = _SUBST + ("food", "beverage")
# timepiece ⊂ measuring_instrument ⊂ instrument ⊂ device (WN3.0 — r5 fix:
# rounds ≤4 skipped the instrument/device links)
_TIMEPIECE = _DEV + ("instrument", "measuring_instrument", "timepiece")
# support.n.10 ("any DEVICE that bears the weight of another") ⊂ device
_SUPPORT = _DEV + ("support",)
_RACK = _INSTR + ("support", "framework")
_SHEETPAPER = _ART + ("sheet", "paper")
# plumbing_fixture ⊂ fixture ⊂ artifact (WN3.0 — r5 polysemy audit fix:
# rounds ≤4 hung plumbing_fixture under instrumentality/furnishing)
_PLUMB = _ART + ("fixture", "plumbing_fixture")

# --- vocabulary: word -> one or more hypernym chains ----------------------
# (chain EXCLUDES the word itself; the full path is prefix + (word,))
_V: Dict[str, List[Chain]] = {
    # classic calibration pair (real WordNet 3.0 paths)
    "dog": [_ANIMAL + ("carnivore", "canine")],
    "cat": [_ANIMAL + ("carnivore", "feline")],
    # furniture — _EXACT subtree, verbatim WordNet 3.0:
    #   table.n.02 ⊂ furniture;  desk.n.01 ⊂ table.n.02
    #   seat.n.03 ⊂ furniture;   chair/stool/bench/sofa ⊂ seat;
    #   armchair ⊂ chair;        bed.n.01 ⊂ bedroom_furniture ⊂ furniture
    #   cabinet.n.01, wardrobe.n.01 (lemmas: closet, press),
    #   chest_of_drawers.n.01 (lemmas: dresser, chest, bureau),
    #   bookcase.n.01 ⊂ furniture;  nightstand.n.01 ⊂ table.n.02
    "table": [_FURN], "desk": [_FURN + ("table",)],
    "chair": [_SEAT], "armchair": [_SEAT + ("chair",)],
    "stool": [_SEAT], "bench": [_SEAT], "sofa": [_SEAT],
    # ottoman is a lemma of footstool.n.01 ⊂ stool (WN3.0)
    "ottoman": [_SEAT + ("stool",)],
    "bed": [_FURN + ("bedroom_furniture",)],
    "mattress": [_FURN + ("bedroom_furniture",)],
    "cabinet": [_FURN], "wardrobe": [_FURN],
    "chest_of_drawers": [_FURN], "nightstand": [_FURN + ("table",)],
    # shelf.n.01 ⊂ support.n.10 ⊂ device (WN3.0 — NOT furniture)
    "shelf": [_SUPPORT],
    "bookshelf": [_SUPPORT + ("shelf",)],
    "drawer": [_CONT], "counter": [_FURN + ("table",)],
    "lamp": [_DEV + ("source_of_illumination",)],
    # chandelier.n.01 ⊂ lighting_fixture ⊂ fixture ⊂ artifact in WN3.0 —
    # NOT a lamp hyponym (r5 polysemy audit: the old lamp-child chain
    # OVERestimated chandelier-vs-lamp 10x by crossing the 0.925 line)
    "chandelier": [_ART + ("fixture", "lighting_fixture")],
    # light.n.02 ("light, light_source") is a SIBLING of lamp under
    # source_of_illumination in WN3.0, not a lamp hyponym (r5 fix); the
    # illumination-effect sense ⊂ visual_property (sibling of color) is
    # vendored too so light-vs-color pairs take the higher abstract path
    "light": [_DEV + ("source_of_illumination",),
              _ABST + ("attribute", "property", "visual_property")],
    "candle": [_DEV + ("source_of_illumination",)],
    # appliances / machines
    "refrigerator": [_WGOODS],
    "fridge": [_WGOODS + ("refrigerator",)],   # electric_refrigerator ⊂ refrigerator (WN3.0)
    # microwave, microwave_oven ⊂ oven (WN3.0)
    "stove": [_KAPPL], "oven": [_KAPPL], "microwave": [_KAPPL + ("oven",)],
    "dishwasher": [_WGOODS], "washing_machine": [_WGOODS],
    "machine": [_DEV],
    # heater.n.01 ("device that heats water or supplies warmth") ⊂ device
    # directly in WN3.0 (r5 fix: rounds ≤4 hung it under home_appliance);
    # radiator.n.02 ⊂ heater (the car radiator.n.01 ⊂ cooling_system is
    # not vendored — radiator stays approximation)
    "heater": [_DEV], "fan": [_DEV],
    "radiator": [_DEV + ("heater",)],
    "treadmill": [_MACH + ("exercise_device",)],
    # sewing_machine ⊂ textile_machine ⊂ machine (WN3.0 — r5 audit: the
    # direct machine-child chain overestimated vs-machine 10x by crossing
    # the 0.925 line: 0.941 full weight where NLTK gives 0.9 x0.1)
    "sewing_machine": [_MACH + ("textile_machine",)],
    "exercise_equipment": [_MACH + ("exercise_device",)],
    # electronics — television_receiver ⊂ receiver ⊂ set.n.13 ⊂
    # electronic_equipment (WN3.0)
    "television": [_ELEC + ("set", "receiver")],
    # laptop ⊂ portable_computer ⊂ personal_computer ⊂ digital_computer
    # ⊂ computer ⊂ machine (WN3.0)
    "computer": [_MACH],
    "laptop": [_MACH + ("computer", "digital_computer",
                        "personal_computer", "portable_computer")],
    "monitor": [_ELEC], "keyboard": [_DEV],
    # mouse: BOTH WN3.0 senses that matter in an indoor-scene vocabulary —
    # mouse.n.04 (computer science) ⊂ electronic_device ⊂ device, and
    # mouse.n.01 the rodent (r5 fix: rounds ≤4 vendored only an
    # electronic_equipment chain, so mouse-vs-cat missed the rodent path)
    "mouse": [_DEV + ("electronic_device",), _ANIMAL + ("rodent",)],
    "printer": [_MACH], "speaker": [_ELEC],
    "radio": [_ELEC + ("set", "receiver")],
    "telephone": [_ELEC],
    "remote_control": [_DEV],
    "switch": [_DEV],
    # the electrical outlet IS wall_socket.n.01 ("wall_socket, wall_plug,
    # electric_outlet, electrical_outlet, outlet, electric_receptacle") ⊂
    # receptacle.n.01 ⊂ container in WN3.0 (r5 wave 6 — rounds ≤5.5 hung
    # it under device); tray shares the receptacle parent
    "outlet": [_CONT + ("receptacle",)],
    "charger": [_DEV],
    "clock": [_TIMEPIECE],
    # cable.n.02 ("cable, line, transmission_line") ⊂ conductor — a
    # SIBLING of wire.n.01, not its child (r5 audit: the wire-child chain
    # said 0.941 full weight; NLTK gives 0.889 x0.1)
    "cable": [_INSTR + ("conductor",)],
    "wire": [_INSTR + ("conductor",)],
    # containers / vessels / kitchenware
    "bottle": [_VESSEL], "jar": [_VESSEL],
    # cup.n.01 / dish.n.01 ⊂ crockery ⊂ tableware (WN3.0)
    "cup": [_TABLEWARE + ("crockery",)],
    # mug ⊂ drinking_vessel ⊂ vessel (WN3.0)
    "mug": [_VESSEL + ("drinking_vessel",)], "glass": [_VESSEL],
    "bowl": [_VESSEL], "pot": [_VESSEL], "pan": [_VESSEL + ("cooking_pot",)],
    # kettle, boiler ⊂ pot (WN3.0)
    "kettle": [_VESSEL + ("pot",)], "vase": [_VESSEL + ("jar",)],
    "box": [_CONT], "bag": [_CONT], "basket": [_CONT],
    # suitcase IS bag.n.06 ("bag, traveling_bag, travelling_bag, grip,
    # suitcase") ⊂ baggage ("baggage, luggage") ⊂ case — vendored for BOTH
    # words in _EXTRA_SYNSETS (shared terminal -> suitcase-vs-bag = 1.0 as
    # NLTK scores it; the old case-child chain said 0.082)
    # backpack, knapsack, rucksack ⊂ bag.n.01 (WN3.0)
    "backpack": [_CONT + ("bag",)],
    # trash_can is a lemma of ashcan.n.01 ⊂ bin (garbage_can: same synset,
    # see _ALIASES); garbage_bin is NOT a WN3.0 lemma — vendored chain is
    # deliberately more generous than the reference's empty-synsets 0.0
    "trash_can": [_CONT + ("bin",)], "garbage_bin": [_CONT + ("bin",)],
    "bin": [_CONT], "bucket": [_VESSEL], "tray": [_CONT + ("receptacle",)],
    # sink.n.01 / toilet.n.01 (the commode synset: lemmas "toilet, can,
    # commode, crapper, pot, potty, stool, throne") ⊂ plumbing_fixture ⊂
    # fixture ⊂ artifact (WN3.0); pot and stool join that synset through
    # _EXTRA_SYNSETS below, so pot/stool/toilet pairs score 1.0 as NLTK does
    "sink": [_PLUMB], "bathtub": [_VESSEL],
    "toilet": [_PLUMB],
    "faucet": [_DEV + ("regulator",)],
    "plate": [_TABLEWARE + ("flatware",)],
    "dish": [_TABLEWARE + ("crockery",)],
    "knife": [_CUTLERY], "fork": [_CUTLERY], "spoon": [_CUTLERY],
    "chopstick": [_CUTLERY],
    # coverings / textiles / clothing
    # curtain.n.01 has TWO WN3.0 hypernyms — blind.n.03 ("a protective
    # covering that keeps things out or hinders sight") and furnishing.n.02
    # — both vendored (r5 polysemy audit; rounds ≤4 used a non-WordNet
    # "furnishing_textile" node). "blinds" morphy-lemmatizes to blind.n.03
    # itself, so curtain-vs-blinds is a parent/child 0.941 ≥ 0.925 (no
    # downweight), as real NLTK scores it.
    "curtain": [_COVER + ("protective_covering", "blind"),
                _INSTR + ("furnishing",)],
    "blind": [_COVER + ("protective_covering",)],
    "towel": [_ART + ("fabric", "piece_of_cloth")],
    "napkin": [_ART + ("fabric", "piece_of_cloth")],
    "tissue": [_ART + ("fabric", "piece_of_cloth")],
    # bedclothes ⊂ cloth_covering ⊂ covering (WN3.0)
    "blanket": [_COVER + ("cloth_covering", "bedclothes")],
    "sheet": [_COVER + ("cloth_covering", "bedclothes")],
    # bedsheets: NOT a WN3.0 lemma (morphy's "bedsheet" is not in the
    # index; the synset lemma is "bed_sheet") — generous sheet-child
    # chain, documented in the non-lemma bucket (the reference scores it
    # 0.0 via empty synsets)
    "bedsheets": [_COVER + ("cloth_covering", "bedclothes", "sheet")],
    # pillow ⊂ cushion ⊂ padding ⊂ artifact (WN3.0 — not bedclothes)
    "pillow": [_ART + ("padding", "cushion")],
    "cushion": [_ART + ("padding",)],
    # rug, carpet, carpeting are ONE synset ⊂ floor_cover (see _ALIASES)
    "carpet": [_COVER + ("floor_cover",)],
    "mat": [_COVER + ("floor_cover",)],
    "clothes": [_CLOTH], "jacket": [_CLOTH + ("garment", "coat")],
    "coat": [_CLOTH + ("garment",)], "shirt": [_CLOTH + ("garment",)],
    "hat": [_CLOTH + ("headdress",)], "shoe": [_CLOTH + ("footwear",)],
    # structure / surfaces
    "door": [_STRUCT + ("obstruction", "barrier", "movable_barrier")],
    "window": [_STRUCT + ("opening",)],
    "wall": [_STRUCT + ("partition",)],
    "floor": [_SURFACE + ("horizontal_surface",)],
    "ceiling": [_SURFACE + ("upper_surface",)],
    "ladder": [_INSTR + ("stairway",)],
    "rack": [_INSTR + ("support", "framework")],
    "hook": [_INSTR + ("support", "holder")],
    "hanger": [_INSTR + ("support", "holder")],
    "frame": [_INSTR + ("support", "framework")],
    "mirror": [_DEV + ("reflector",)],
    # paper / pictures / writing
    "book": [_PAPER + ("publication",)],
    "notebook": [_PAPER + ("publication", "book")],
    "paper": [_ART + ("sheet",)], "poster": [_ART + ("sheet",)],
    "calendar": [_ART + ("sheet",)], "map": [_ART + ("sheet",)],
    # photograph.n.01 ⊂ representation.n.02 in WN3.0 — a SIBLING of the
    # picture/image synset, not its child (r5 polysemy audit: the old
    # picture-child chain OVERestimated photo-vs-picture 10x, 0.947 full
    # weight where NLTK scores ~0.0875 downweighted); painting's only
    # vendored chains are the {painting, picture} shared synset + its
    # graphic_art path (_EXTRA_SYNSETS)
    "picture": [_PAPER + ("representation",)],
    "photograph": [_PAPER + ("representation",)],
    "board": [_SURFACE], "whiteboard": [_SURFACE + ("board",)],
    "blackboard": [_SURFACE + ("board",)],
    "pen": [_WRITING], "pencil": [_WRITING],
    # decorations / misc
    "decoration": [_DECOR], "ornament": [_DECOR],
    # plaything.n.01 lemmas are "plaything, toy" — "toy" carries this synset
    # PLUS its toy_dog sense via _EXTRA_SYNSETS (it is not a plain alias:
    # "plaything" is NOT a lemma of toy_dog.n.01, so the two words have
    # different sense inventories); doll and teddy_bear are children
    "plaything": [_ART],
    "doll": [_ART + ("plaything",)],
    "teddy_bear": [_ART + ("plaything",)],
    # ball.n.01 ⊂ game_equipment ⊂ equipment (WN3.0 — not plaything)
    "ball": [_EQUIP + ("game_equipment",)],
    "guitar": [_DEV + ("musical_instrument", "stringed_instrument")],
    # piano has THREE WN3.0 hypernyms: keyboard, stringed, and percussion
    # instrument — all vendored so the max-over-synsets matches NLTK
    "piano": [_DEV + ("musical_instrument", "keyboard_instrument"),
              _DEV + ("musical_instrument", "stringed_instrument"),
              _DEV + ("musical_instrument", "percussion_instrument")],
    "umbrella": [_DEV + ("canopy",)],
    "bicycle": [_INSTR + ("conveyance", "vehicle", "wheeled_vehicle")],
    "soap": [_PHYS + ("matter", "substance", "cleansing_agent")],
    "brush": [_UTENSIL + ("cleaning_implement",)],
    "toothbrush": [_UTENSIL + ("cleaning_implement", "brush")],
    "sponge": [_UTENSIL + ("cleaning_implement",)],
    "comb": [_DEV],
    # living / food
    "plant": [_LIVING],
    "flower": [_PLANT + ("spermatophyte", "angiosperm")],
    "tree": [_PLANT + ("woody_plant",)],
    "person": [_LIVING],
    "man": [_LIVING + ("person", "adult")],
    "woman": [_LIVING + ("person", "adult")],
    "child": [_LIVING + ("person", "juvenile")],
    "fish": [_LIVING + ("animal", "chordate", "vertebrate",
                        "aquatic_vertebrate")],
    "bird": [_LIVING + ("animal", "chordate", "vertebrate")],
    "food": [_FOOD], "bread": [_FOOD + ("baked_goods",)],
    "cake": [_FOOD + ("baked_goods",)],
    "fruit": [_FRUIT[:-2]],
    "apple": [_FRUIT],
    "banana": [_FRUIT],
    # orange.n.01 ⊂ citrus ⊂ edible_fruit (WN3.0); + the chromatic sense
    "orange": [_FRUIT + ("citrus",), _CHROM],
    "lemon": [_FRUIT + ("citrus",)],
    "vegetable": [_FOOD + ("produce",)],
    "tomato": [_FOOD + ("produce", "vegetable")],
    "egg": [_FOOD], "cereal": [_FOOD], "sugar": [_FOOD], "salt": [_FOOD],
    "milk": [_BEV], "juice": [_BEV], "coffee": [_BEV], "tea": [_BEV],
    "wine": [_BEV + ("alcohol",)],
    "water": [_PHYS + ("matter", "liquid")],
    # colors — _EXACT, verbatim WordNet 3.0: {red,blue,green,yellow,brown,
    # pink,purple}.n.01 ⊂ chromatic_color; violet ("reddish_blue") ⊂ purple;
    # {white,black,gray}.n ⊂ achromatic_color ("grey" is a lemma of gray)
    "red": [_CHROM], "blue": [_CHROM], "green": [_CHROM],
    "yellow": [_CHROM], "brown": [_CHROM], "pink": [_CHROM],
    "purple": [_CHROM], "violet": [_CHROM + ("purple",)],
    "white": [_ACHROM], "black": [_ACHROM], "gray": [_ACHROM],
    "beige": [_CHROM + ("brown",)],
    "tan": [_CHROM + ("brown",)],
    "silver": [_ACHROM + ("gray",)], "gold": [_CHROM + ("yellow",)],
    "dark": [_ABST + ("attribute", "state")],
    # --- round-3 coverage expansion (vendored DAQUAR vocabulary audit,
    # data/daquar_vocab.py): furniture
    "headboard": [_FURN + ("bedroom_furniture", "bed")],
    # crib, cot ⊂ baby_bed ⊂ furniture (WN3.0 — a sibling of bed's
    # bedroom_furniture subtree, not a child of bed)
    "crib": [_FURN + ("baby_bed",)],
    "bunk_bed": [_FURN + ("bedroom_furniture", "bed")],
    "bookcase": [_FURN],
    "cupboard": [_FURN + ("cabinet",)],
    # sideboard's WN3.0 sense IS the buffet synset ("buffet, counter,
    # sideboard" ⊂ furniture) — vendored via _EXTRA_SYNSETS; the old
    # cabinet-child chain overestimated vs-cabinet 10x (0.947 full weight)
    "file_cabinet": [_FURN + ("cabinet",)],
    "countertop": [_FURN + ("table", "counter")],
    "rocking_chair": [_SEAT + ("chair",)],
    "office_chair": [_SEAT + ("chair",)],
    "coffee_table": [_FURN + ("table",)],
    "dining_table": [_FURN + ("table",)],
    # lighting
    "candlestick": [_INSTR + ("support", "holder")],
    "floor_lamp": [_DEV + ("source_of_illumination", "lamp")],
    "table_lamp": [_DEV + ("source_of_illumination", "lamp")],
    "desk_lamp": [_DEV + ("source_of_illumination", "lamp")],
    "night_light": [_DEV + ("source_of_illumination", "lamp")],
    "lamp_shade": [_COVER + ("shade",)],
    # appliances / machines
    "toaster": [_KAPPL], "blender": [_KAPPL],
    "coffee_machine": [_KAPPL], "coffee_maker": [_KAPPL],
    "dryer": [_APPL], "iron": [_APPL], "vacuum_cleaner": [_APPL],
    "air_conditioner": [_APPL],
    "hair_dryer": [_APPL + ("dryer",)],
    "ceiling_fan": [_DEV + ("fan",)],   # follows fan.n.01 ⊂ device (r5)
    "stapler": [_MACH],
    "ironing_board": [_SURFACE + ("board",)],
    # electronics
    "scanner": [_ELEC], "stereo": [_ELEC], "game_console": [_ELEC],
    "headphones": [_ELEC], "modem": [_ELEC], "router": [_ELEC],
    "dvd_player": [_ELEC], "cd_player": [_ELEC],
    "screen": [_ELEC + ("display",)],
    "projector": [_DEV + ("optical_device",)],
    "camera": [_DEV + ("optical_device",)],
    "glasses": [_DEV + ("optical_device",)],
    "sunglasses": [_DEV + ("optical_device", "spectacles")],
    "light_switch": [_DEV + ("switch",)],
    "doorknob": [_DEV],
    "alarm_clock": [_TIMEPIECE + ("clock",)],
    "wall_clock": [_TIMEPIECE + ("clock",)],
    "watch": [_TIMEPIECE],
    # containers / kitchenware
    "purse": [_CONT + ("bag",)],
    "wallet": [_CONT + ("case",)],
    # wastebasket ("wastepaper_basket, wastebasket, waste_basket,
    # circular_file") ⊂ basket in WN3.0, NOT ⊂ bin (r5 audit);
    # laundry_basket ("clothes_hamper, laundry_basket, clothes_basket")
    # ⊂ hamper ⊂ basket
    "waste_basket": [_CONT + ("basket",)],
    "laundry_basket": [_CONT + ("basket", "hamper")],
    "hamper": [_CONT + ("basket",)],
    "container": [_INSTR],
    "folder": [_CONT],
    "file": [_CONT],
    "envelope": [_CONT],
    "jug": [_VESSEL], "pitcher": [_VESSEL],
    "teapot": [_VESSEL + ("pot",)],
    "flower_pot": [_VESSEL + ("pot",)],
    "water_bottle": [_VESSEL + ("bottle",)],
    "wine_bottle": [_VESSEL + ("bottle",)],
    "saucer": [_TABLEWARE + ("flatware",)],
    "soap_dish": [_TABLEWARE + ("crockery", "dish")],
    "cutting_board": [_SURFACE + ("board",)],
    "dish_rack": [_RACK + ("rack",)],
    "towel_rack": [_RACK + ("rack",)],
    # textiles / coverings / clothing
    "shower_curtain": [_COVER + ("protective_covering", "blind", "curtain"),
                       _INSTR + ("furnishing", "curtain")],
    "tablecloth": [_ART + ("fabric", "piece_of_cloth")],
    "toilet_paper": [_SHEETPAPER],
    # paper_towel.n.01 ("a disposable towel made of absorbent paper") ⊂
    # towel.n.01 ⊂ piece_of_cloth in WN3.0 (wave 6 — rounds ≤5.5 put it in
    # the sheet/paper subtree, scoring paper_towel-vs-towel ~0.06 where
    # NLTK gives the parent/child 0.941 at full weight)
    "paper_towel": [_ART + ("fabric", "piece_of_cloth", "towel")],
    "bath_mat": [_COVER + ("floor_cover", "mat")],
    "doormat": [_COVER + ("floor_cover", "mat")],
    "clothing": [_COVER],
    "pants": [_CLOTH + ("garment",)],
    "scarf": [_CLOTH + ("garment",)],
    "tie": [_CLOTH + ("garment",)],
    "apron": [_CLOTH + ("garment",)],
    # belt ⊂ accessory ⊂ clothing (r5 audit: the direct clothing-child
    # chain said 0.933 full weight; NLTK gives 0.875 x0.1)
    "belt": [_CLOTH + ("accessory",)],
    "slippers": [_CLOTH + ("footwear", "shoe")],
    "sock": [_CLOTH + ("footwear",)],
    # fabric.n.01's lemmas are "fabric, cloth, material, textile" — cloth
    # is an ALIAS (wave 6; the old fabric-child chain scored cloth-vs-towel
    # 0.933 full weight where NLTK gives 0.857 x0.1, and cloth-vs-fabric
    # 0.941 where NLTK gives exactly 1.0)
    "fabric": [_ART],
    # structure / fixtures
    "windowsill": [_SURFACE + ("horizontal_surface",)],
    "stairs": [_INSTR + ("stairway",)],
    "railing": [_STRUCT + ("obstruction", "barrier")],
    "banister": [_STRUCT + ("obstruction", "barrier", "railing")],
    "shower": [_PLUMB],
    "pipe": [_INSTR + ("conduit",)],
    "vent": [_STRUCT + ("opening",)],
    "fireplace": [_STRUCT],
    # mantel/mantelpiece (lemma "mantle") ⊂ shelf ⊂ support.n.10 in WN3.0 —
    # NOT a fireplace hyponym (r5 polysemy audit fix); the cloak garment
    # sense is vendored too (mantle ⊂ cloak ⊂ garment)
    "mantle": [_SUPPORT + ("shelf",), _CLOTH + ("garment", "cloak")],
    # (mantle is ALSO a curtain.n.01 lemma — "curtain, drape, drapery,
    # mantle, pall" — vendored via _EXTRA_SYNSETS: mantle-vs-curtain = 1.0)
    "column": [_STRUCT + ("structural_member",)],
    "beam": [_STRUCT + ("structural_member",)],
    "partition": [_STRUCT],
    "tile": [_ART],
    "tiles": [_ART + ("tile",)],
    "bulletin_board": [_SURFACE + ("board",)],
    "corkboard": [_SURFACE + ("board",)],
    # paper / media
    "magazine": [_PAPER + ("publication",)],
    "newspaper": [_PAPER + ("publication",)],
    "marker": [_WRITING],
    "card": [_SHEETPAPER],
    "sticker": [_SHEETPAPER],
    "document": [_PAPER],
    "letter": [_PAPER],
    # decorations / misc
    "stuffed_animal": [_ART + ("plaything", "doll")],
    # basketball/football (the balls) ⊂ ball ⊂ game_equipment; note the
    # DAQUAR normalization "basket_ball" is not itself a WN3.0 lemma
    "basket_ball": [_EQUIP + ("game_equipment", "ball")],
    "football": [_EQUIP + ("game_equipment", "ball")],
    "video_game": [_ART + ("plaything",)],
    "drum": [_DEV + ("musical_instrument", "percussion_instrument")],
    "shampoo": [_SUBST + ("cleansing_agent",)],
    "toothpaste": [_SUBST + ("cleansing_agent",)],
    "perfume": [_SUBST + ("toiletry",)],
    "lotion": [_SUBST + ("toiletry",)],
    "medicine": [_SUBST],
    "glue": [_SUBST],
    "scissors": [_TOOL],
    "tape": [_ART],
    "key": [_DEV],
    "jewelry": [_DECOR + ("adornment",)],
    "globe": [_PAPER + ("representation",)],
    "statue": [_PAPER + ("representation",)],
    "figurine": [_PAPER + ("representation", "statue")],
    "trophy": [_DECOR],
}

# Words the WUPS metric sees that have NO noun synsets in WordNet 3.0 —
# the reference scores them 0.0 (wup_measure.py:42-43: empty synsets), so
# the faithful behavior here is OOV-scores-0, NOT a vendored chain.
NO_NOUN_SYNSET = frozenset({"transparent", "colorful", "bright"})

# Lemma aliases — words WordNet resolves (via morphy or shared lemmas) to
# the SAME synset as the canonical word, so wup == 1.0 between them.
# Round 3 modeled these as parent/child nodes (scoring ~0.89-0.95 where
# NLTK returns exactly 1.0); this table reproduces the reference behavior.
_ALIASES: Dict[str, str] = {
    # same-synset lemmas (WordNet 3.0)
    "couch": "sofa",                 # sofa.n.01: "sofa, couch, lounge"
    "closet": "wardrobe",            # wardrobe.n.01: "wardrobe, closet, press"
    "dresser": "chest_of_drawers",   # chest_of_drawers.n.01: "... dresser"
    "night_stand": "nightstand",     # nightstand.n.01: "nightstand, night stand"
    "grey": "gray",                  # gray.n.01: "gray, grey, greyness"
    "tv": "television",              # television.n.02: "television, tv, telly"
    "photo": "photograph",           # photograph.n.01: "photograph, photo, exposure"
    "phone": "telephone",            # telephone.n.01: "telephone, phone"
    "bike": "bicycle",               # bicycle.n.01: "bicycle, bike, wheel, cycle"
    "remote": "remote_control",      # remote_control.n.01: "remote control, remote"
    # NOTE: "bedsheets" is deliberately NOT an alias — morphy gives
    # "bedsheet", which is not a WordNet 3.0 lemma (sheet.n.03's lemmas
    # are "sheet, bed_sheet"), so the reference scores it 0.0; it carries
    # a documented-generous chain in _V instead (non-lemma bucket).
    "rug": "carpet",                 # rug.n.01: "rug, carpet, carpeting"
    "cloth": "fabric",               # fabric.n.01: "fabric, cloth, material, textile"
    "blinds": "blind",               # morphy: blinds -> blind.n.03
    "garbage_can": "trash_can",      # ashcan.n.01: "ashcan, trash_can, garbage_can, ..."
    # plural forms (morphy lemmatizes to the singular's synsets)
    "shelves": "shelf", "books": "book", "flowers": "flower",
    "plants": "plant", "shoes": "shoe", "socks": "sock",
    "sheets": "sheet", "curtains": "curtain", "toys": "toy",
    "keys": "key", "cards": "card", "tiles": "tile",
    "papers": "paper", "fruits": "fruit", "vegetables": "vegetable",
}

# materialize full paths: every chain above excludes the word itself
_FULL: Dict[str, List[Chain]] = {
    w: [c + (w,) for c in chains] for w, chains in _V.items()
}

# numbers: digit and spelled forms are lemmas of the SAME synset (WordNet
# lists "2" as a lemma of two.n.01), so "2" vs "two" scores 1.0.
# WordNet 3.0 places 0-9 under digit.n.01 but ten/eleven/twelve under
# large_integer.n.01 (both ⊂ integer), so e.g. wup(nine, ten) = 0.75,
# not the 0.875 of two digit siblings.
_NUMBER_WORDS = ["zero", "one", "two", "three", "four", "five", "six",
                 "seven", "eight", "nine", "ten", "eleven", "twelve"]
_LARGE_INT = _NUM[:-1] + ("large_integer",)
for _i, _w in enumerate(_NUMBER_WORDS):
    _chain = (_LARGE_INT if _i >= 10 else _NUM) + (_w,)
    _FULL[_w] = [_chain]
    _FULL[str(_i)] = [_chain]

# --- secondary-sense synsets (round-5 polysemy audit) ----------------------
# The reference's metric maxes over ALL of a word's noun synsets
# (wup_measure.py:46-51) — including slang and technical senses. These FULL
# chains (terminal = the synset's canonical WN3.0 name, so two words that
# share a synset share the terminal and score 1.0) vendor the secondary
# senses whose omission produced the largest divergences vs real NLTK:
#
#   * pot / stool / toilet are all lemmas of the commode synset
#     ("toilet, can, commode, crapper, pot, potty, stool, throne" ⊂
#     plumbing_fixture) -> pot-vs-stool is 1.0 in NLTK, NOT a downweighted
#     cross-category pair. The one full-magnitude case among exact words.
#   * toy is a lemma of toy_dog.n.01 ⊂ dog -> toy-vs-dog = 28/29 ≈ 0.966,
#     ABOVE the 0.925 threshold (no downweight).
#   * board and table share the meals synset ("board, table" ⊂ fare) ->
#     board-vs-table = 1.0.
#   * bag and purse share handbag.n.01 ("bag, handbag, pocketbook, purse"
#     ⊂ bag.n.01) -> bag-vs-purse = 1.0.
#   * glass is a lemma of looking_glass.n.01 ⊂ mirror -> glass-vs-mirror
#     = 18/19 ≈ 0.947 (no downweight).
#   * painting and picture share painting.n.01 ("painting, picture" ⊂
#     graphic_art) -> painting-vs-picture = 1.0.
#   * kettle is a lemma of kettledrum ⊂ percussion_instrument ->
#     kettle-vs-drum = 0.9 (x0.1 regime, but 9x the vessel-path value).
#   * dog is a lemma of andiron ("andiron, firedog, dog, dog-iron" ⊂
#     support.n.10) -> dog-vs-shelf = 8/9 ≈ 0.889 (x0.1 regime).
#   * bird is a lemma of shuttlecock ("shuttlecock, bird, birdie, shuttle"
#     ⊂ badminton_equipment) -> bird-vs-ball ≈ 0.737 (x0.1 regime).
#
# Terminal synset names and the parent/same-synset relations are verbatim
# WordNet 3.0; intermediate prefix nodes of the secondary chains are
# best-effort (they only influence cross-pairs against OTHER subtrees, all
# in the x0.1 regime). Remaining KNOWN unvendored senses are listed in
# ``KNOWN_UNVENDORED_SENSES`` below.
_METAL = _PHYS + ("matter", "substance", "chemical_element",
                  "metallic_element")
_COMMODE = _PLUMB + ("toilet",)
_MEALS = _FOOD + ("fare", "board")
_HANDBAG = _CONT + ("bag", "handbag")
_PAINTING = _ART + ("creation", "art", "graphic_art", "painting")
# containerful.n.01 ⊂ indefinite_quantity ⊂ measure — the measure-side
# senses of vessels ("the quantity a <vessel> will hold": cupful, glassful,
# bowl.n.03)
_CONTAINERFUL = _ABST + ("measure", "indefinite_quantity", "containerful")
# nutriment.n.01 ⊂ food.n.01 ⊂ substance (NOT the solid-food food.n.02 ⊂
# solid path) — dish.n.02 "a particular item of prepared food" lives here
_NUTRIMENT = _SUBST + ("food", "nutriment")
_EXTRA_SYNSETS: Dict[str, List[Chain]] = {
    "pot": [_COMMODE],
    "stool": [_COMMODE],
    "toy": [_ART + ("plaything",),
            _ANIMAL + ("carnivore", "canine", "dog", "toy_dog")],
    "table": [_MEALS],
    # bag: handbag.n.01 ("bag, handbag, pocketbook, purse") AND bag.n.06
    # (the suitcase synset — see the "suitcase" entry below)
    "bag": [_HANDBAG, _CONT + ("case", "baggage", "traveling_bag")],
    "purse": [_HANDBAG],
    "glass": [_DEV + ("reflector", "mirror", "looking_glass"),
              # glassful.n.01 ("the quantity a glass will hold") ⊂
              # containerful — cupful's sibling, mirroring cup.n.02
              _CONTAINERFUL + ("glassful",)],
    "painting": [_PAINTING],
    "picture": [_PAINTING],
    # mantle is a lemma of curtain.n.01 ("curtain, drape, drapery, mantle,
    # pall" ⊂ blind.n.03): identical full chain to curtain's -> 1.0
    "mantle": [_COVER + ("protective_covering", "blind", "curtain")],
    # notebook/notebook_computer ⊂ portable_computer (the laptop sibling):
    # notebook-vs-laptop = 24/26 ≈ 0.923, just UNDER the 0.925 line
    "notebook": [_MACH + ("computer", "digital_computer",
                          "personal_computer", "portable_computer",
                          "notebook")],
    # metallic-element senses (approximation-grade prefix): silver/gold ⊂
    # noble_metal siblings -> silver-vs-gold rides the metal path (0.875,
    # x0.1 regime), not the color path's gray-vs-yellow (0.6); iron Fe ⊂
    # metallic_element
    "silver": [_METAL + ("noble_metal", "silver")],
    "gold": [_METAL + ("noble_metal", "gold")],
    "iron": [_METAL + ("iron",)],
    # cup.n.02 (cupful) ⊂ containerful ⊂ indefinite_quantity ⊂ measure —
    # the sense that dominates cup-vs-number pairs under real NLTK
    "cup": [_CONTAINERFUL + ("cup",)],
    # wave 6 — same-synset collisions and secondary senses found by
    # auditing the remaining non-exact words against each other:
    # "paper" is a lemma of newspaper.n.01 ("newspaper, paper"):
    # paper-vs-newspaper is 1.0 under NLTK (the sheet-path cross pair said
    # 0.059 — the largest single divergence left in the module)
    "paper": [_PAPER + ("publication", "newspaper")],
    # blind.n.03's lemmas are "blind, screen" — the vocabulary word screen
    # shares curtain's hypernym synset: screen-vs-blind(s) = 1.0,
    # screen-vs-curtain = 0.941 full weight (the electronic-display chain
    # scored both ~0.05)
    "screen": [_COVER + ("protective_covering", "blind")],
    # "glasses" reaches ALL of glass's senses under NLTK (morphy strips
    # -ses -> glass) IN ADDITION to its own spectacles synset:
    # glasses-vs-glass = 1.0, glasses-vs-mirror = 0.947 via looking_glass
    "glasses": [_VESSEL + ("glass",),
                _DEV + ("reflector", "mirror", "looking_glass"),
                _CONTAINERFUL + ("glassful",)],
    # bowl's WN3.0 sense inventory beyond the round vessel: bowl ⊂
    # dish.n.01 ("a dish that is round and open at the top" — soup bowl:
    # bowl-vs-dish = 0.952 FULL weight, was a 0.05 vessel/crockery cross
    # pair), bowl ⊂ ball.n.01 ("a wooden ball used in lawn bowling":
    # bowl-vs-ball = 0.947 full weight), and bowl.n.03 (bowlful) ⊂
    # containerful
    "bowl": [_TABLEWARE + ("crockery", "dish", "bowl"),
             _EQUIP + ("game_equipment", "ball", "bowl"),
             _CONTAINERFUL + ("bowl",)],
    # dish.n.02 ("a particular item of prepared food") ⊂ nutriment — and
    # cake.n.02 ("cake, patty — small flat mass of chopped food") is its
    # CHILD: cake-vs-dish = 0.933 full weight under NLTK (the crockery/
    # baked_goods cross pair said ~0.03)
    "dish": [_NUTRIMENT + ("dish",)],
    "cake": [_NUTRIMENT + ("dish", "cake")],
    # food.n.01 ("any substance that can be metabolized...") ⊂ substance —
    # the parent of nutriment and beverage; vendoring it lets
    # dish/cake/beverage pairs against "food" ride the real LCS
    "food": [_SUBST + ("food",)],
    # bag.n.06 ("bag, traveling_bag, travelling_bag, grip, suitcase") ⊂
    # baggage ⊂ case — the suitcase sense of "bag" and the ONLY WN3.0
    # synset of "suitcase": the two words share it, so the pair is 1.0.
    # The distinct terminal keeps bag.n.06 separate from bag.n.01 (a
    # single "bag" terminal would falsely give suitcase-vs-purse the
    # handbag path).
    "suitcase": [_CONT + ("case", "baggage", "traveling_bag")],
    "kettle": [_DEV + ("musical_instrument", "percussion_instrument",
                       "kettledrum")],
    "dog": [_DEV + ("support", "andiron")],
    "bird": [_EQUIP + ("sports_equipment", "badminton_equipment",
                       "shuttlecock")],
    # board is a lemma of dining_table.n.01 ("dining_table, board"):
    # board-vs-dining_table = 1.0 (the chain is dining_table's own)
    "board": [_MEALS, _FURN + ("table", "dining_table")],
    # counter and sideboard are both lemmas of buffet.n.01
    # ("buffet, counter, sideboard" ⊂ furniture)
    "counter": [_FURN + ("buffet",)],
    "sideboard": [_FURN + ("buffet",)],
    # file is a lemma of file.n.03 ("file, file_cabinet, filing_cabinet"
    # ⊂ cabinet) — the chain is file_cabinet's own, so
    # file-vs-file_cabinet = 1.0 and file-vs-cabinet = 0.947
    "file": [_FURN + ("cabinet", "file_cabinet")],
}
for _w, _chains in _EXTRA_SYNSETS.items():
    _FULL.setdefault(_w, []).extend(_chains)

# --- provenance ------------------------------------------------------------
# Words whose vendored chains are VERBATIM WordNet 3.0 hypernym paths
# (hand-derived; see module docstring for the secondary-synset caveat and
# the spot checks that the vendored max survives it within this set).
_EXACT = frozenset(
    # colors (chromatic_color / achromatic_color subtrees)
    ["red", "blue", "green", "yellow", "brown", "pink", "purple", "violet",
     "white", "black", "gray", "grey", "beige", "tan"]
    # numbers: digits 1-9 ⊂ digit, 10-12 ⊂ large_integer, + digit lemmas
    + [w for i, w in enumerate(_NUMBER_WORDS) if i >= 1]
    + [str(i) for i in range(1, 13)]
    # fauna/flora: classic WN3.0 paths (dog/cat via carnivore; bird/fish
    # via vertebrate; plant.n.02 ⊂ organism; tree ⊂ woody_plant; flower
    # ⊂ angiosperm ⊂ spermatophyte ⊂ vascular_plant)
    + ["dog", "cat", "bird", "fish", "plant", "plants", "tree",
       "flower", "flowers"]
    # furniture subtree (see chain comments above) + round-5 derivations:
    # counter/coffee_table/dining_table/nightstand ⊂ table; rocking_chair
    # ⊂ chair; ottoman lemma of footstool ⊂ stool; bunk_bed ⊂ bed; crib
    # ⊂ baby_bed
    + ["table", "desk", "chair", "armchair", "stool", "bench", "sofa",
       "couch", "bed", "cabinet", "wardrobe", "closet", "chest_of_drawers",
       "dresser", "nightstand", "night_stand", "bookcase", "counter",
       "coffee_table", "dining_table", "rocking_chair", "ottoman",
       "bunk_bed", "crib"]
    # containers/vessels: box/bag/basket/bin ⊂ container; ashcan (lemmas
    # trash_can, garbage_can) ⊂ bin; bottle/jar/pot/bucket ⊂ vessel;
    # vase ⊂ jar; kettle/teapot ⊂ pot; water_bottle/wine_bottle ⊂ bottle;
    # mug ⊂ drinking_vessel; backpack ⊂ bag
    + ["box", "bag", "basket", "bin", "trash_can", "garbage_can",
       "bottle", "jar", "vase", "pot", "kettle", "teapot", "bucket",
       "water_bottle", "wine_bottle", "mug", "backpack"]
    # white goods + kitchen appliances: refrigerator/dishwasher/
    # washing_machine ⊂ white_goods; fridge (electric_refrigerator) ⊂
    # refrigerator; stove/oven/toaster ⊂ kitchen_appliance; microwave ⊂
    # oven; machine/computer ⊂ device/machine; laptop's 5-link path
    + ["refrigerator", "fridge", "stove", "oven", "microwave", "toaster",
       "dishwasher", "washing_machine", "machine", "computer", "laptop"]
    # lamps (⊂ source_of_illumination ⊂ device), electronics (telephone ⊂
    # electronic_equipment; tv/radio ⊂ receiver ⊂ set), timepieces (clock/
    # watch ⊂ timepiece ⊂ measuring_instrument ⊂ instrument ⊂ device)
    + ["lamp", "floor_lamp", "table_lamp", "television", "tv",
       "telephone", "phone", "radio", "clock", "watch", "alarm_clock"]
    # writing implements, publications, musical instruments, playthings,
    # game equipment, shelving (support.n.10)
    + ["pen", "pencil", "book", "books", "notebook", "magazine",
       "guitar", "piano", "drum", "toy", "toys", "doll", "teddy_bear",
       "ball", "shelf", "shelves", "bookshelf"]
    # floor covers, cushions/bedclothes, cloth, cutlery, conveyance
    + ["carpet", "rug", "mat", "doormat", "towel", "pillow", "cushion",
       "blanket", "sheet", "sheets", "fork", "spoon",
       "bicycle", "bike"]
    # round-5 second batch — single-noun-sense words whose full WN3.0
    # synset inventory is enumerable offline: mirror ⊂ reflector ⊂ device;
    # keyboard/remote_control ⊂ device (remote is a remote_control.n.01
    # lemma); faucet ⊂ regulator ⊂ device; heater ⊂ device (its only other
    # sense, the baseball fastball ⊂ pitch, lives in the act subtree no
    # vocabulary word shares); tray ⊂ receptacle ⊂ container; wallet ⊂
    # case ⊂ container; bathtub ⊂ vessel; wall_clock ⊂ clock; stapler ⊂
    # machine; vacuum_cleaner ⊂ home_appliance
    + ["mirror", "keyboard", "remote_control", "remote", "faucet",
       "heater", "tray", "wallet", "bathtub", "wall_clock", "stapler",
       "vacuum_cleaner"]
    # round-5 polysemy audit: toilet's primary chain is the verbatim
    # commode synset ⊂ plumbing_fixture ⊂ fixture (its room/grooming
    # senses are registered in KNOWN_UNVENDORED_SENSES)
    + ["toilet"]
    # wave 6 — words whose full WN3.0 noun-sense inventory is enumerable
    # offline and whose vendored chains are verbatim; every secondary
    # sense is either vendored or registered in KNOWN_UNVENDORED_SENSES:
    # mouse (electronic_device + rodent chains both vendored), fan ⊂
    # device, sink ⊂ plumbing_fixture, pitcher ("pitcher, ewer" ⊂ vessel),
    # hamper ⊂ basket, clothes_hamper (lemma laundry_basket) ⊂ hamper,
    # wastepaper_basket (lemma waste_basket) ⊂ basket, radiator ⊂ heater,
    # blind/blinds = blind.n.03 ⊂ protective_covering, curtain/curtains ⊂
    # {blind.n.03, furnishing.n.02} (BOTH real hypernyms vendored),
    # shower_curtain ⊂ curtain, paper_towel ⊂ towel, newspaper ⊂
    # publication
    + ["mouse", "fan", "sink", "pitcher", "hamper", "laundry_basket",
       "waste_basket", "radiator", "blind", "blinds", "curtain",
       "curtains", "shower_curtain", "paper_towel", "newspaper",
       # suitcase's ONLY WN3.0 synset is bag.n.06 ("bag, traveling_bag,
       # travelling_bag, grip, suitcase" ⊂ baggage ⊂ case), vendored for
       # both words -> suitcase-vs-bag = 1.0
       "suitcase"])


def provenance(word: str) -> str:
    """``wordnet-3.0-exact`` | ``approximation`` | ``no-noun-synset`` |
    ``oov`` — see module docstring."""
    if word in _EXACT:
        return "wordnet-3.0-exact"
    if word in NO_NOUN_SYNSET:
        return "no-noun-synset"
    if _ALIASES.get(word, word) in _FULL:
        return "approximation"
    return "oov"


# --- known UNVENDORED secondary senses (round-5 polysemy audit) -------------
# The reference maxes over ALL noun synsets, so a word's score can ride a
# slang or technical sense this module does not vendor. Each entry below is
# a WordNet 3.0 sense we know exists but chose not to vendor; for every one
# EXCEPT the explicitly-flagged cup prize-sense entry, the affected pairs
# lie in the sub-threshold x0.1 regime (max absolute error ≤ ~0.09 before
# downweight, ≤ ~0.009..0.02 after), because every full-magnitude
# (≥ 0.925) case found by the audit whose chain IS derivable offline is
# vendored in ``_EXTRA_SYNSETS``. A word appearing here can still be ``_EXACT`` — its
# vendored chains are verbatim — but pairs against the named subtrees may
# UNDERESTIMATE real NLTK within the downweighted regime.
# tools/audit_wups_vs_nltk.py verifies this registry on a corpus-ful host.
KNOWN_UNVENDORED_SENSES: Dict[str, Tuple[str, ...]] = {
    "fork": ("farm fork ⊂ tool (raises fork-vs-{pen,pencil,scissors})",),
    "spoon": ("golf wood 'spoon' ⊂ golf equipment (raises spoon-vs-ball)",),
    "mat": ("gym mat ⊂ sports_equipment (raises mat-vs-ball)",),
    "bench": ("'bench' as a workbench lemma ⊂ work_table "
              "(raises bench-vs-{table,desk})",),
    "box": ("box/boxwood shrub ⊂ shrub ⊂ woody_plant "
            "(raises box-vs-{tree,plant})",),
    "gray": ("gray horse ⊂ mount ⊂ horse (raises gray-vs-{dog,cat})",),
    "pen": ("female swan 'pen' ⊂ swan (raises pen-vs-bird)",),
    "drum": ("drumfish ⊂ sciaenid fish (raises drum-vs-fish)",),
    "machine": ("lemma of car.n.01 ⊂ motor_vehicle "
                "(raises machine-vs-{bicycle,bike})",),
    "chair": ("electric_chair ⊂ instrument_of_execution ⊂ instrument "
              "(raises chair-vs-device words)",
              "chairperson ⊂ presiding_officer (person subtree)"),
    "table": ("tabular_array ⊂ arrangement (abstraction side)",),
    "red": ("lemma of the Bolshevik synset ⊂ radical (person subtree; "
            "pairs vs other words' person senses)",),
    "dog": ("cad/frump person senses and frank/hotdog food sense "
            "(person and food subtrees)",),
    "cat": ("guy/hombre ⊂ man (person subtree)",
            "big-cat sense structure differences",
            "Caterpillar tractor ⊂ wheeled vehicle "
            "(raises cat-vs-{bicycle,bike})",
            "cat-o'-nine-tails ⊂ whip"),
    "computer": ("human calculator ⊂ expert (person subtree)",),
    "bird": ("slang 'bird' ⊂ woman (person subtree)",),
    "toy": ("miniature/replica sense ⊂ copy ⊂ representation",),
    "toilet": ("lavatory room sense ⊂ room", "grooming act sense"),
    "watch": ("duty-period sense ⊂ time_period (measure subtree; "
              "raises watch-vs-number words)",),
    "plant": ("industrial-plant sense ⊂ building_complex ⊂ structure "
              "(raises plant-vs-structure words)",),
    "bed": ("machine-bed foundation sense ⊂ foundation ⊂ support "
            "(device subtree)", "stream-bed / flower-bed natural senses"),
    "tree": ("tree-diagram sense ⊂ plane_figure (abstraction side)",),
    "closet": ("cupboard sense ('cupboard, closet') — raises "
               "closet-vs-cupboard toward 1.0",
               "water-closet sense (raises closet-vs-toilet)",),
    "white": ("egg-white/albumen sense (food subtree; raises "
              "white-vs-food-side chains)",
              "White person-sense (ties the 0.875 color value for "
              "white-vs-black; person subtree otherwise)",),
    "ball": ("formal-dance sense ⊂ party (event subtree)",
             "testis body-part sense"),
    # the ONE registry entry NOT bounded to the x0.1 regime (see the
    # module docstring): cup's prize-cup sense ("a large metal vessel
    # with two handles that is awarded as a trophy") has a hypernym we
    # cannot re-derive offline — if it is trophy, cup-vs-trophy is ~0.93
    # FULL weight under real NLTK; if it is vessel, the pair stays x0.1.
    # Vendoring either guess risks the 10x-overestimate class wave 3
    # fixed, so it is registered honestly instead.
    "cup": ("prize-cup sense — hypernym underivable offline (trophy -> "
            "full-weight cup-vs-trophy, vessel -> x0.1); NOT x0.1-bounded",
            "golf-hole cup sense (x0.1)"),
    # wave-6 promotions — each promoted word's remaining senses:
    "mouse": ("black-eye/shiner sense ⊂ bruise (injury subtree)",
              "timid-person sense (person subtree)"),
    "fan": ("enthusiast/devotee person senses ⊂ person subtree "
            "(sub-threshold vs person/man/woman/child)",),
    "sink": ("sinkhole ⊂ natural_depression (natural_object side)",
             "cesspool/sump sense (possibly the cistern/tank subtree — "
             "x0.1 vs vessels)",
             "(technology) energy-sink process sense (abstraction side)"),
    "pitcher": ("ballplayer sense ⊂ person subtree",
                "pitcherful ⊂ containerful (x0.1 vs cupful/glassful)",
                "pitcher-plant leaf sense ⊂ plant_organ "
                "(natural_object side)"),
    "hamper": ("restraint/shackle sense ⊂ restraint ⊂ device "
               "(x0.1 vs device words)",),
    "radiator": ("car-radiator sense ⊂ cooling_system (device/mechanism "
                 "subtree, x0.1)",),
    "curtain": ("curtain.n.02 'barrier to communication or vision' ⊂ "
                "barrier (x0.1 vs door/railing/banister)",),
    "blind": ("subterfuge sense (abstraction side)",
              "'the blind' people sense ⊂ people (group subtree)"),
    "newspaper": ("publisher-firm sense (group subtree)",
                  "newsprint sense ⊂ paper material (substance side)",
                  "physical single-copy sense ⊂ product (x0.1 vs "
                  "publications)"),
    # registry back-fill on words exact since earlier waves:
    "magazine": ("gun cartridge-holder sense ⊂ supply_chamber (x0.1)",
                 "powder-store and publisher-business senses"),
    "basket": ("basketball-hoop sense ⊂ goal (game_equipment subtree, "
               "x0.1 vs ball)", "basketful ⊂ containerful"),
    "bottle": ("bottleful ⊂ containerful (x0.1 vs cupful/glassful)",),
    "bucket": ("bucketful ⊂ containerful (x0.1)",),
}


def unvendored_senses(word: str) -> Tuple[str, ...]:
    """Known WordNet 3.0 senses of ``word`` this module does not vendor
    (empty tuple when none are known). The word's own entry wins over its
    alias-canonical entry (a sense can belong to the alias FORM only:
    closet's cupboard sense is not wardrobe's). See
    KNOWN_UNVENDORED_SENSES."""
    own = KNOWN_UNVENDORED_SENSES.get(word)
    if own is not None:
        return own
    return KNOWN_UNVENDORED_SENSES.get(_ALIASES.get(word, word), ())


# --- per-word documented reasons for non-exact words (VERDICT r4 #3:
# "every word is provenance-exact or has a documented reason") -------------
# Bucket (a): the synset (or one on its path) has MULTIPLE hypernyms in
# WordNet 3.0, which this module's tree-shaped chain model linearizes —
# the vendored single chain is a documented under-approximation.
# person.n.01 ⊂ {organism, causal_agent}; edible fruits ⊂ {produce, fruit};
# clothing.n.01 ⊂ {covering, consumer_goods} pulls the whole garment
# subtree in; food.n.02 ⊂ {substance}.. vs food.n.01 ⊂ matter.
_MULTI_INHERITANCE = frozenset({
    # person.n.01 ⊂ {organism, causal_agent}
    "person", "man", "woman", "child",
    # edible_fruit.n.01 ⊂ {fruit, produce}; apple adds pome, tomato adds
    # solanaceous_vegetable — all multi-parent
    "apple", "banana", "orange", "lemon", "tomato", "fruit", "fruits",
    # clothing.n.01 ⊂ {covering, consumer_goods}: the garment subtree
    # (garment/hosiery ⊂ clothing) inherits the split
    "clothes", "clothing", "coat", "jacket", "shirt", "pants", "hat",
    "scarf", "sock", "socks", "tie", "apron",
})
# Bucket (c): DAQUAR's space->underscore answer normalization produced
# strings that are not WordNet 3.0 lemmas at all — the reference scores
# them 0.0 through empty synsets (wup_measure.py:42-43), so ANY vendored
# chain here is deliberately MORE generous than the reference.
_NON_LEMMA_NORMALIZATION = frozenset({
    "garbage_bin", "flower_pot", "basket_ball", "office_chair",
    "desk_lamp", "coffee_machine", "exercise_equipment", "game_console",
    # r5 polysemy audit additions — answer strings that are not WordNet
    # 3.0 lemmas (incl. "bedsheets", whose morphy form "bedsheet" is not
    # in the index); all carry deliberately-generous vendored chains
    "bedsheets", "light_switch", "ceiling_fan", "dvd_player",
    "stuffed_animal",
})
# Everything else: bucket (b) — a real WordNet word whose exact 3.0
# hypernym chain or full noun-sense inventory we could not re-derive with
# offline certainty (no corpus in this image); the vendored chain is a
# category-placed approximation. tools/audit_wups_vs_nltk.py quantifies
# the residue on any corpus-ful machine.


def non_exact_reason(word: str) -> Optional[str]:
    """Documented bucket for every non-exact vocabulary word; None for
    exact / no-noun-synset / OOV words (their provenance() says it all)."""
    if provenance(word) != "approximation":
        return None
    if word in _MULTI_INHERITANCE:
        return "multiple-inheritance-linearized"
    if word in _NON_LEMMA_NORMALIZATION:
        return "non-lemma-normalization-scored-generously"
    return "chain-underivable-offline"


def exactness_stats(words: Sequence[str]) -> Dict[str, float]:
    """Share of ``words`` (and of unordered word pairs) whose WUPS values
    are believed reference-exact (both sides in ``_EXACT``), plus the
    STRICT variant: pairs where additionally neither side carries a known
    unvendored secondary sense (KNOWN_UNVENDORED_SENSES), i.e. pairs whose
    value cannot even be perturbed within the x0.1 regime by WordNet
    polysemy this module knows about but does not vendor."""
    n = len(words)
    e = sum(1 for w in words if w in _EXACT)
    s = sum(1 for w in words if w in _EXACT and not unvendored_senses(w))
    return {
        "words": n,
        "exact_words": e,
        "exact_word_pct": 100.0 * e / n if n else 0.0,
        "exact_pair_pct": 100.0 * e * e / (n * n) if n else 0.0,
        "sense_complete_exact_words": s,
        "strict_exact_pair_pct": 100.0 * s * s / (n * n) if n else 0.0,
    }


def synsets(word: str) -> List[Chain]:
    """Full hypernym paths (root-first, ending in the synset's own name).
    Aliases resolve to their canonical synset's chains (wup == 1.0 between
    alias and canonical, as NLTK's morphy/lemma lookup behaves)."""
    return _FULL.get(_ALIASES.get(word, word), [])


def wup(chain_a: Sequence[str], chain_b: Sequence[str]) -> float:
    """Wu-Palmer similarity of two root-first hypernym paths."""
    common = 0
    for x, y in zip(chain_a, chain_b):
        if x != y:
            break
        common += 1
    if common == 0:
        return 0.0
    return 2.0 * common / (len(chain_a) + len(chain_b))


def max_wup(word_a: str, word_b: str) -> float:
    """Most-optimistic pairwise wup over both words' synsets; -1 when either
    word is out of vocabulary (caller distinguishes OOV from zero overlap)."""
    a, b = synsets(word_a), synsets(word_b)
    if not a or not b:
        return -1.0
    return max(wup(x, y) for x in a for y in b)


def vocabulary() -> List[str]:
    return sorted(set(_V.keys()) | set(_ALIASES.keys())
                  | set(_EXTRA_SYNSETS.keys()))
