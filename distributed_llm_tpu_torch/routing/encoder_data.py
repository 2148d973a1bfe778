"""Paraphrase pair generation for the trained semantic encoder.

Counterpart of ``distributed_llm_tpu/routing/encoder_data.py``, pure
numpy and the same templates, pools and draws, so both packages give the
same lists for a seed.  The reference's semantic strategy and cache ride
a pretrained sentence encoder (all-MiniLM-L6-v2,
src/query_router_engine.py:122-131, 508-511) that scores PARAPHRASES
high even with disjoint wording.  With no pretrained weights, the
capability is trained in-repo: this module generates (anchor,
paraphrase) pairs from meaning-keyed template groups (each group holds
several surface forms of the same question, slots filled from shared
entity pools), giving a contrastive corpus where positives share meaning
but often share almost no words ("what's the capital of X" / "name X's
seat of government").

Groups are split train/heldout BY GROUP, so evaluation measures transfer
to unseen meanings, not memorized templates.  bench/query_sets.py texts
are never used for training: they stay a clean routing-accuracy eval.
The label texts are the port's own copy (``routing/semantic_labels.json``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# Slot pools: everyday vocabulary (the serving distribution, as the JAX
# package's training/data.py draws it) plus fresh entities.
_COUNTRIES = ("france japan brazil canada egypt kenya norway peru india "
              "spain greece chile cuba iran poland turkey vietnam "
              "morocco sweden portugal").split()
_TOPICS = ("photosynthesis gravity inflation evolution electricity "
           "magnetism fermentation erosion respiration combustion "
           "relativity probability recursion encryption compression "
           "pollination condensation oxidation cryptography "
           "virtualization concurrency caching databases microservices "
           "superconductivity thermodynamics").split() + [
           # Multi-word tech entities: serving queries talk about these,
           # and an entity the encoder never saw embeds unconstrained
           # (observed: "hello" vs an unseen quantum-computing query
           # scored 0.29, above the cache threshold).
           "quantum computing", "machine learning", "neural networks",
           "distributed systems", "operating systems", "version control"]
_ANIMALS = ("whale falcon cheetah octopus beaver python salmon spider "
            "elephant penguin dolphin eagle tortoise moth lynx").split()
_LANGS = ("python javascript rust go java ruby kotlin swift").split()
_TASKS = ("sort a list", "reverse a string", "merge two arrays",
          "parse a date", "count word frequencies",
          "flatten a nested list", "deduplicate records",
          "validate an email", "binary search a sorted array",
          "compute a running average")
_DEVICES = ("laptop phone router printer camera headset monitor "
            "keyboard speaker drone").split()
_FOODS = ("bread cheese pasta rice curry salad soup pancakes tofu "
          "dumplings omelette stew").split()
_CITIES = ("paris tokyo nairobi lima oslo madrid athens havana "
           "warsaw istanbul hanoi lisbon").split()

# Each group: a slot pool name and >=4 surface forms of ONE meaning.
# {x} is the slot.  Forms are written to MINIMIZE shared content words
# between at least some pairs (the hashing embedder's blind spot).
TEMPLATE_GROUPS: List[Dict] = [
    {"pool": _COUNTRIES, "forms": [
        "what is the capital of {x}?",
        "name {x}'s capital city",
        "which city serves as the seat of government in {x}?",
        "tell me {x}'s capital",
        "the main governing city of {x} is called what?",
    ]},
    {"pool": _COUNTRIES, "forms": [
        "how many people live in {x}?",
        "what is the population of {x}?",
        "give me {x}'s headcount of residents",
        "how big is {x} in terms of inhabitants?",
    ]},
    {"pool": _COUNTRIES, "forms": [
        "what currency is used in {x}?",
        "what money do they spend in {x}?",
        "name the legal tender of {x}",
        "if i travel to {x}, what cash should i carry?",
    ]},
    {"pool": _TOPICS, "forms": [
        "explain {x} in simple terms",
        "give me an easy description of {x}",
        "how would you describe {x} to a beginner?",
        "break down {x} so a child could follow",
        "what is {x}, plainly put?",
    ]},
    {"pool": _TOPICS, "forms": [
        "why does {x} matter in everyday life?",
        "what makes {x} important day to day?",
        "how is {x} relevant to ordinary people?",
        "give reasons {x} affects daily living",
    ]},
    {"pool": _TOPICS, "forms": [
        "write a detailed technical analysis of {x} with examples",
        "produce an in-depth report covering {x}, citing concrete cases",
        "compose a thorough expert treatment of {x} including worked "
        "illustrations",
        "draft a comprehensive deep dive on {x} with supporting evidence",
    ]},
    {"pool": _ANIMALS, "forms": [
        "what does a {x} eat?",
        "describe the diet of a {x}",
        "what food keeps a {x} alive?",
        "tell me what {x}s feed on",
    ]},
    {"pool": _ANIMALS, "forms": [
        "where do {x}s live in the wild?",
        "what habitat suits a {x}?",
        "in which environments is a {x} found?",
        "name the natural home of the {x}",
    ]},
    {"pool": _LANGS, "forms": [
        "write a hello world program in {x}",
        "show the smallest runnable {x} example that prints a greeting",
        "give me starter {x} code that outputs hello",
        "how do i print hello world using {x}?",
    ]},
    {"pool": _LANGS, "forms": [
        "what are the main strengths of {x}?",
        "why would a team pick {x} for a new project?",
        "list the advantages of building software in {x}",
        "sell me on {x} as a development choice",
    ]},
    {"pool": _TASKS, "forms": [
        "write code to {x}",
        "implement a function that can {x}",
        "show me a program which will {x}",
        "how do i {x} programmatically?",
    ]},
    {"pool": _DEVICES, "forms": [
        "my {x} will not turn on, what should i check?",
        "troubleshoot a {x} that refuses to power up",
        "the {x} stays dead when i press the button — ideas?",
        "help me revive a {x} that shows no sign of life",
    ]},
    {"pool": _DEVICES, "forms": [
        "how do i reset a {x} to factory settings?",
        "walk me through wiping a {x} back to its defaults",
        "what are the steps to restore a {x} to out-of-box state?",
    ]},
    {"pool": _FOODS, "forms": [
        "how do i make {x} at home?",
        "give me a simple recipe for {x}",
        "what are the steps to cook {x} myself?",
        "teach me to prepare {x} in my own kitchen",
    ]},
    {"pool": _FOODS, "forms": [
        "how long does {x} keep in the fridge?",
        "what is the shelf life of refrigerated {x}?",
        "when does stored {x} go bad?",
    ]},
    {"pool": _CITIES, "forms": [
        "what is the weather like in {x} today?",
        "give me today's forecast for {x}",
        "is it raining in {x} right now?",
        "current conditions in {x}, please",
    ]},
    {"pool": _CITIES, "forms": [
        "what should a tourist see in {x}?",
        "list the top attractions of {x}",
        "which sights are worth visiting in {x}?",
        "plan the highlights of a short trip to {x}",
    ]},
    {"pool": _TOPICS, "forms": [
        "compare {x} with its closest alternative and analyze trade-offs",
        "contrast {x} against competing explanations, weighing pros and "
        "cons",
        "evaluate {x} side by side with rival approaches in depth",
    ]},
    {"pool": _ANIMALS, "forms": [
        "how fast can a {x} move?",
        "what top speed does a {x} reach?",
        "tell me the quickest pace of a {x}",
    ]},
    {"pool": _LANGS, "forms": [
        "debug why my {x} program crashes on startup",
        "my {x} app dies immediately when launched — find the cause",
        "investigate an instant crash in a {x} application",
    ]},
    # Small-talk group: the nano-class openers the cache sees constantly.
    {"pool": ["morning", "afternoon", "evening"], "forms": [
        "good {x}! how are you?",
        "hello, hope your {x} is going well",
        "hi there, happy {x} to you",
    ]},
    {"pool": ["joke", "story", "poem"], "forms": [
        "tell me a {x}",
        "share a short {x} with me",
        "got a good {x}?",
    ]},
    {"pool": _COUNTRIES, "forms": [
        "what language do people speak in {x}?",
        "which tongue is native to {x}?",
        "name the official language of {x}",
        "in {x}, what do locals talk in?",
    ]},
    {"pool": _TOPICS, "forms": [
        "give a one sentence summary of {x}",
        "sum up {x} in a single line",
        "condense {x} into one short statement",
        "briefly, what is {x} about?",
    ]},
    {"pool": _TOPICS, "forms": [
        "what are common misconceptions about {x}?",
        "which wrong beliefs do people hold regarding {x}?",
        "list myths surrounding {x} and correct them",
        "where does popular understanding of {x} go astray?",
    ]},
    {"pool": _ANIMALS, "forms": [
        "how long does a {x} usually live?",
        "what is the typical lifespan of a {x}?",
        "tell me the life expectancy of the {x}",
        "a {x} survives for roughly how many years?",
    ]},
    {"pool": _LANGS, "forms": [
        "how do i read a file line by line in {x}?",
        "show {x} code that iterates over the lines of a file",
        "what is the idiomatic way to process a file per line using {x}?",
    ]},
    {"pool": _TASKS, "forms": [
        "explain the fastest algorithm to {x} and prove its complexity",
        "derive the optimal approach to {x}, analyzing its running time",
        "what method can {x} most efficiently, and why is it optimal?",
    ]},
    {"pool": _FOODS, "forms": [
        "is {x} healthy to eat every day?",
        "are there downsides to eating {x} daily?",
        "what happens to my body if i have {x} all the time?",
    ]},
    {"pool": _CITIES, "forms": [
        "how expensive is living in {x}?",
        "what does it cost to reside in {x}?",
        "give me a sense of {x}'s cost of living",
        "could i afford rent and food in {x}?",
    ]},
    {"pool": _DEVICES, "forms": [
        "my {x} battery drains too fast, how do i fix it?",
        "the {x} dies within hours — how can i extend its charge?",
        "stop a {x} from running out of power so quickly",
    ]},
    {"pool": ["meeting", "interview", "exam", "presentation"], "forms": [
        "how should i prepare for a {x} tomorrow?",
        "give me tips to get ready for an upcoming {x}",
        "what is the best way to walk into a {x} well prepared?",
    ]},
    # Short-text hard negatives: tiny queries are the cache's bread and
    # butter, and without these groups the encoder squeezed ALL short
    # texts together ("hello" vs "what is 2+2" scored above real
    # paraphrase pairs).  Each group is one meaning; in-batch training
    # makes greetings/arithmetic/thanks/farewells mutual negatives.
    {"pool": ["hi", "hello", "hey"], "forms": [
        "{x}!",
        "{x}, how are you?",
        "{x} there, what's up?",
        "{x}, nice to meet you",
    ]},
    {"pool": ["2+2", "3+5", "7*8", "10-4", "12/3", "9+6", "15+27"],
     "forms": [
        "what is {x}?",
        "compute {x}",
        "{x} equals what?",
        "solve {x} for me",
        "give me the result of {x}",
    ]},
    {"pool": ["help", "assistance", "a hand"], "forms": [
        "thanks for {x}!",
        "i appreciate {x}",
        "much obliged for {x}",
        "grateful for {x}",
    ]},
    {"pool": ["now", "later", "soon"], "forms": [
        "goodbye for {x}",
        "see you {x}",
        "i have to go, catch you {x}",
        "bye, talk {x}",
    ]},
    {"pool": ["today", "tomorrow", "this weekend"], "forms": [
        "what day is it {x}?",
        "tell me the date {x}",
        "which day of the week falls {x}?",
    ]},
]

# Group indices reserved for EVALUATION (never trained): spans pools and
# wording-disjointness levels.
HELDOUT_GROUPS = (1, 5, 8, 12, 16, 20)


def _augment(text: str, rng: np.random.Generator) -> str:
    """Light surface noise: drop a word, strip punctuation, or pass
    through — the cache must tolerate sloppy re-typings."""
    r = rng.random()
    if r < 0.15:
        words = text.split()
        if len(words) > 3:
            del words[int(rng.integers(len(words)))]
            return " ".join(words)
    elif r < 0.3:
        return text.replace("?", "").replace("!", "").replace(",", "")
    return text


def _pairs_from_group(group: Dict, rng: np.random.Generator,
                      n_per_entity: int = 2,
                      augment: bool = False) -> List[Tuple[str, str]]:
    forms = group["forms"]
    out = []
    for x in group["pool"]:
        for _ in range(n_per_entity):
            i, j = rng.choice(len(forms), size=2, replace=False)
            a, b = forms[i].format(x=x), forms[j].format(x=x)
            if augment:
                a, b = _augment(a, rng), _augment(b, rng)
            out.append((a, b))
    return out


def contrastive_pairs(split: str = "train", seed: int = 7,
                      n_per_entity: int = 3) -> List[Tuple[str, str]]:
    """(anchor, positive) paraphrase pairs.  ``split``: "train" uses the
    training groups plus semantic_labels.json self-pairs; "heldout" uses
    only the reserved groups (unseen meanings)."""
    rng = np.random.default_rng(seed)
    held = set(HELDOUT_GROUPS)
    pairs: List[Tuple[str, str]] = []
    for gi, group in enumerate(TEMPLATE_GROUPS):
        if (gi in held) != (split == "heldout"):
            continue
        pairs.extend(_pairs_from_group(group, rng, n_per_entity,
                                       augment=(split == "train")))
    if split == "train":
        # Label texts as weak self-supervision: pair each text with
        # lightly word-dropped copies of itself (robustness to deletion).
        # These texts double as the semantic strategy's centroid sources,
        # so anchoring them — several augmented variants each — both
        # stabilizes centroids and supplies in-batch negatives against
        # every other meaning.
        import json
        import os
        labels = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "semantic_labels.json")
        with open(labels) as f:
            for row in json.load(f):
                words = row["text"].split()
                for _ in range(3):
                    if len(words) >= 4:
                        keep = [w for w in words if rng.random() > 0.25]
                        if len(keep) >= 2:
                            pairs.append((row["text"], " ".join(keep)))
                    else:
                        pairs.append((row["text"], row["text"].lower()))
                        break
    order = rng.permutation(len(pairs))
    return [pairs[i] for i in order]


def unrelated_pairs(n: int = 200, seed: int = 11) -> List[Tuple[str, str]]:
    """Texts drawn from DIFFERENT template groups (different meanings) —
    the negative side of threshold calibration."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ga, gb = rng.choice(len(TEMPLATE_GROUPS), size=2, replace=False)
        a, b = TEMPLATE_GROUPS[int(ga)], TEMPLATE_GROUPS[int(gb)]
        fa = a["forms"][rng.integers(len(a["forms"]))]
        fb = b["forms"][rng.integers(len(b["forms"]))]
        out.append((fa.format(x=a["pool"][rng.integers(len(a["pool"]))]),
                    fb.format(x=b["pool"][rng.integers(len(b["pool"]))])))
    return out
