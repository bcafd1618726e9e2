"""Extended grapheme clusters (Unicode UAX #29) without the ``regex``
package, for the ``Precompiled`` tokenizer normalizer, which cuts its text
into clusters as ``tokenizers`` does (``unicode-segmentation``).

Python's ``unicodedata`` has no ``Grapheme_Cluster_Break`` property, so the
classes are derived here: CR, LF and ZWJ by code point; Control from the
general categories Cc, Cf, Zl and Zp; Extend from Mn and Me, the
Other_Grapheme_Extend list and the emoji modifiers; SpacingMark from Mc
less its exceptions; the Hangul syllable types L, V, T, LV and LVT by
code-point arithmetic; Regional_Indicator as U+1F1E6..1F1FF; Prepend and
Extended_Pictographic from small range tables. The rules are GB3-GB9b,
GB9c (Indic conjuncts: a consonant, a virama, a consonant, from the
Indic_Conjunct_Break tables of the six scripts that have them), GB11
(emoji ZWJ sequences) and GB12/13 (flag pairs).
"""

from __future__ import annotations

import bisect
import unicodedata
from functools import lru_cache

(OTHER, CR, LF, CONTROL, EXTEND, ZWJ, RI, PREPEND, SPACING, L, V, T, LV,
 LVT, PICT) = range(15)


def _table(ranges: list[tuple[int, int]]) -> tuple[list[int], list[int]]:
    ranges = sorted(ranges)
    return [a for a, _ in ranges], [b for _, b in ranges]


def _in(table, cp: int) -> bool:
    starts, ends = table
    i = bisect.bisect_right(starts, cp) - 1
    return i >= 0 and cp <= ends[i]


# PropList.txt: Other_Grapheme_Extend
_OTHER_EXTEND = _table([
    (0x09BE, 0x09BE), (0x09D7, 0x09D7), (0x0B3E, 0x0B3E), (0x0B57, 0x0B57),
    (0x0BBE, 0x0BBE), (0x0BD7, 0x0BD7), (0x0CC2, 0x0CC2), (0x0CD5, 0x0CD6),
    (0x0D3E, 0x0D3E), (0x0D57, 0x0D57), (0x0DCF, 0x0DCF), (0x0DDF, 0x0DDF),
    (0x1B35, 0x1B35), (0x200C, 0x200C), (0x302E, 0x302F), (0xFF9E, 0xFF9F),
    (0x1133E, 0x1133E), (0x11357, 0x11357), (0x114B0, 0x114B0),
    (0x114BD, 0x114BD), (0x115AF, 0x115AF), (0x11930, 0x11930),
    (0x1D165, 0x1D165), (0x1D16E, 0x1D172), (0xE0020, 0xE007F),
    (0x1F3FB, 0x1F3FF),  # Emoji_Modifier
])
# Prepend: Indic_Syllabic_Category Consonant_Preceding_Repha /
# Consonant_Prefixed, and Prepended_Concatenation_Mark
_PREPEND = _table([
    (0x0600, 0x0605), (0x06DD, 0x06DD), (0x070F, 0x070F), (0x0890, 0x0891),
    (0x08E2, 0x08E2), (0x0D4E, 0x0D4E), (0x110BD, 0x110BD),
    (0x110CD, 0x110CD), (0x111C2, 0x111C3), (0x1193F, 0x1193F),
    (0x11941, 0x11941), (0x11A3A, 0x11A3A), (0x11A84, 0x11A89),
    (0x11D46, 0x11D46), (0x11F02, 0x11F02),
])
# Mc characters that are not SpacingMark
_NOT_SPACING = _table([
    (0x102B, 0x102C), (0x1038, 0x1038), (0x1062, 0x1064), (0x1067, 0x106D),
    (0x1083, 0x1083), (0x1087, 0x108C), (0x108F, 0x108F), (0x109A, 0x109C),
    (0x1A61, 0x1A61), (0x1A63, 0x1A64), (0xAA7B, 0xAA7B), (0xAA7D, 0xAA7D),
    (0x11720, 0x11721),
])
# emoji-data.txt: Extended_Pictographic
_PICT = _table([
    (0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C), (0x2049, 0x2049),
    (0x2122, 0x2122), (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA),
    (0x231A, 0x231B), (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
    (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB),
    (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605),
    (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
    (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721),
    (0x2728, 0x2728), (0x2733, 0x2734), (0x2744, 0x2744), (0x2747, 0x2747),
    (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
    (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0),
    (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C),
    (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
    (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF),
    (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
    (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A),
    (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A),
    (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
    (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
    (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF),
    (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F),
    (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A),
    (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD),
])
# Indic_Conjunct_Break: Linker (the viramas) and Consonant
_LINKERS = frozenset((0x094D, 0x09CD, 0x0ACD, 0x0B4D, 0x0C4D, 0x0D4D))
_CONSONANT = _table([
    (0x0915, 0x0939), (0x0958, 0x095F), (0x0978, 0x097F), (0x0995, 0x09A8),
    (0x09AA, 0x09B0), (0x09B2, 0x09B2), (0x09B6, 0x09B9), (0x09DC, 0x09DD),
    (0x09DF, 0x09DF), (0x09F0, 0x09F1), (0x0A95, 0x0AA8), (0x0AAA, 0x0AB0),
    (0x0AB2, 0x0AB3), (0x0AB5, 0x0AB9), (0x0AF9, 0x0AF9), (0x0B15, 0x0B28),
    (0x0B2A, 0x0B30), (0x0B32, 0x0B33), (0x0B35, 0x0B39), (0x0B5C, 0x0B5D),
    (0x0B5F, 0x0B5F), (0x0B71, 0x0B71), (0x0C15, 0x0C28), (0x0C2A, 0x0C39),
    (0x0C58, 0x0C5A), (0x0D15, 0x0D3A),
])
# unassigned Default_Ignorable_Code_Point ranges (Control when unassigned)
_IGNORABLE = _table([(0x2060, 0x206F), (0xFFF0, 0xFFF8), (0xE0000, 0xE0FFF)])


@lru_cache(maxsize=4096)
def break_class(ch: str) -> int:
    """The Grapheme_Cluster_Break class of one character."""
    cp = ord(ch)
    if cp == 0x0D:
        return CR
    if cp == 0x0A:
        return LF
    if cp == 0x200D:
        return ZWJ
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return RI
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return L
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return V
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return T
    if 0xAC00 <= cp <= 0xD7A3:
        return LV if (cp - 0xAC00) % 28 == 0 else LVT
    if _in(_PREPEND, cp):
        return PREPEND
    cat = unicodedata.category(ch)
    if cat in ("Mn", "Me") or _in(_OTHER_EXTEND, cp):
        return EXTEND
    if cat in ("Cc", "Cf", "Zl", "Zp") or (cat == "Cn"
                                           and _in(_IGNORABLE, cp)):
        return CONTROL
    if (cat == "Mc" and not _in(_NOT_SPACING, cp)) or cp in (0x0E33, 0x0EB3):
        return SPACING
    if _in(_PICT, cp):
        return PICT
    return OTHER


def _conjunct_class(ch: str, cls: int) -> int:
    """Indic_Conjunct_Break: 1 Consonant, 2 Linker, 3 Extend, 0 None."""
    cp = ord(ch)
    if cp in _LINKERS:
        return 2
    if _in(_CONSONANT, cp):
        return 1
    return 3 if cls == ZWJ or (cls == EXTEND and cp != 0x200C) else 0


def grapheme_clusters(text: str) -> list[str]:
    """``text`` cut into extended grapheme clusters."""
    out: list[str] = []
    start = 0
    prev = -1
    ri_run = 0  # regional indicators ending at the previous character
    pict = False  # the previous characters are ExtPict Extend*
    pict_zwj = False  # ... followed by a ZWJ, which is the previous one
    # GB9c: 1 after Consonant [Extend]*, 2 once a Linker followed it
    conjunct = 0
    for i, ch in enumerate(text):
        cls = break_class(ch)
        if prev >= 0:
            if prev == CR and cls == LF:
                join = True  # GB3
            elif prev in (CONTROL, CR, LF) or cls in (CONTROL, CR, LF):
                join = False  # GB4, GB5
            elif prev == L and cls in (L, V, LV, LVT):
                join = True  # GB6
            elif prev in (LV, V) and cls in (V, T):
                join = True  # GB7
            elif prev in (LVT, T) and cls == T:
                join = True  # GB8
            elif cls in (EXTEND, ZWJ, SPACING) or prev == PREPEND:
                join = True  # GB9, GB9a, GB9b
            elif conjunct == 2 and _conjunct_class(ch, cls) == 1:
                join = True  # GB9c
            elif prev == ZWJ and cls == PICT and pict_zwj:
                join = True  # GB11
            elif prev == RI and cls == RI:
                join = ri_run % 2 == 1  # GB12, GB13
            else:
                join = False  # GB999
            if not join:
                out.append(text[start:i])
                start = i
        incb = _conjunct_class(ch, cls)
        if incb == 1:
            conjunct = 1
        elif incb == 2:
            conjunct = 2 if conjunct else 0
        elif incb == 0:
            conjunct = 0
        pict_zwj = cls == ZWJ and pict
        pict = cls == PICT or (cls == EXTEND and pict)
        ri_run = ri_run + 1 if cls == RI else 0
        prev = cls
    if start < len(text):
        out.append(text[start:])
    return out
