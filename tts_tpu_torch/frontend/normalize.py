"""Text normalization: English + Chinese number/date/time/unit expansion
(a copy of tts_tpu/frontend/normalize.py: the port imports nothing of tts_tpu).

The reference delegates this to tn/WeTextProcessing/inflect
(IndexTTS/Export_IndexTTS.py:589-806, VoxCPM modeling_modified/
text_normalize.py:11-184) — none of which this package depends on. This
module is a self-contained normalizer covering those pipelines' case
families: cardinals, ordinals, decimals, percents, years, currency (with
scale words and non-dollar symbols), dates, clock times, phone numbers /
long digit strings, fractions, measurement units, ranges, negatives — in
both English and Chinese (value-reading numerals with 万/亿 grouping, 幺
phone digits, 百分之 percents, 年月日 dates).

Rule order inside each language pipeline is semantic precedence: composite
patterns (dates, times, phones) consume their digits before generic rules
(ranges, plain cardinals) can misread the pieces.
"""
from __future__ import annotations

import re

__all__ = ["normalize_numbers", "normalize_text", "zh_normalize_numbers",
           "verbalize_emails_urls"]

# ----------------------------------------------------------------- English

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
          (1000, "thousand"), (100, "hundred")]
_ORD_SPECIAL = {"one": "first", "two": "second", "three": "third",
                "five": "fifth", "eight": "eighth", "nine": "ninth",
                "twelve": "twelfth"}
_MONTHS = ["january", "february", "march", "april", "may", "june", "july",
           "august", "september", "october", "november", "december"]
_CURRENCY = {"$": ("dollar", "cent"), "€": ("euro", "cent"),
             "£": ("pound", "penny"), "¥": ("yuan", "fen"),
             "￥": ("yuan", "fen")}
# unambiguous unit suffixes attached to a number (5km, 30kg, 20mph ...)
_UNITS = {
    "km": "kilometer", "cm": "centimeter", "mm": "millimeter",
    "kg": "kilogram", "mg": "milligram", "lb": "pound", "lbs": "pound",
    "oz": "ounce", "mi": "mile", "ft": "foot", "ml": "milliliter",
    "kb": "kilobyte", "mb": "megabyte", "gb": "gigabyte", "tb": "terabyte",
    "hz": "hertz", "khz": "kilohertz", "mhz": "megahertz",
    "ghz": "gigahertz", "mph": "mile per hour", "kph": "kilometer per hour",
    "ms": "millisecond", "kw": "kilowatt", "mw": "megawatt",
}
_UNIT_PLURAL_IRREGULAR = {"foot": "feet", "hertz": "hertz",
                          "kilohertz": "kilohertz",
                          "megahertz": "megahertz", "gigahertz": "gigahertz"}


def _int_to_words(n: int) -> str:
    if n < 0:
        return "minus " + _int_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + ("" if r == 0 else " " + _ONES[r])
    for value, name in _SCALE:
        if n >= value:
            head, rest = divmod(n, value)
            out = _int_to_words(head) + " " + name
            if rest:
                out += " " + _int_to_words(rest)
            return out
    return str(n)


def _ordinal_words(n: int) -> str:
    words = _int_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORD_SPECIAL:
        last = _ORD_SPECIAL[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " + last).strip()


def _year_words(n: int) -> str:
    """1984 -> nineteen eighty four; 2024 -> twenty twenty four;
    2005 -> two thousand five."""
    if 1000 <= n <= 1999 or 2010 <= n <= 9999:
        hi, lo = divmod(n, 100)
        if lo == 0:
            return _int_to_words(hi) + " hundred"
        lo_w = _int_to_words(lo) if lo >= 10 else "oh " + _ONES[lo]
        return _int_to_words(hi) + " " + lo_w
    return _int_to_words(n)


def _num_token_to_words(tok: str) -> str:
    if "." in tok:
        whole, frac = tok.split(".", 1)
        frac_words = " ".join(_ONES[int(c)] for c in frac if c.isdigit())
        whole_w = _int_to_words(int(whole)) if whole else "zero"
        if not whole:
            return f"point {frac_words}"
        return f"{whole_w} point {frac_words}"
    return _int_to_words(int(tok))


def _digits_words(digits: str) -> str:
    return " ".join(_ONES[int(c)] for c in digits if c.isdigit())


# --------------------------------------------------------- email / URL

_EMAIL_RE = re.compile(
    r"\b([a-zA-Z0-9][a-zA-Z0-9._%+-]*)@([a-zA-Z0-9][a-zA-Z0-9.-]*\.[a-zA-Z]{2,})\b")
_URL_RE = re.compile(
    r"\b(?:https?://)?(www\.[a-zA-Z0-9.-]+\.[a-zA-Z]{2,}|"
    r"(?:[a-zA-Z0-9-]+\.)+(?:com|org|net|io|ai|gov|edu|cn)\b)((?:/[\w.-]*)*)")


def _spell_host(host: str) -> str:
    """'example.co.uk' -> 'example dot co dot uk', digits read out."""
    parts = []
    for label in host.split("."):
        label = re.sub(r"\d+", lambda m: " " + _digits_words(m.group(0)) + " ",
                       label)
        parts.append(label.strip())
    return " dot ".join(parts)


def _verbalize_email(m) -> str:
    local = m.group(1).replace(".", " dot ").replace("_", " underscore ")
    local = local.replace("-", " dash ").replace("+", " plus ")
    local = re.sub(r"\d+", lambda g: " " + _digits_words(g.group(0)) + " ",
                   local)
    return re.sub(r"\s+", " ",
                  f"{local.strip()} at {_spell_host(m.group(2))}")


def _verbalize_url(m) -> str:
    out = _spell_host(m.group(1))
    for seg in (m.group(2) or "").split("/"):
        if seg:
            out += " slash " + seg.replace(".", " dot ").replace(
                "-", " dash ")
    return out


def verbalize_emails_urls(text: str) -> str:
    """Read emails as 'local at host dot tld' and URLs as
    'host dot tld slash path' — the reference detects email shapes
    (Export_IndexTTS.py:635-638) and delegates the reading to its tn/wetext
    dependency; here the reading is self-contained."""
    text = _EMAIL_RE.sub(_verbalize_email, text)
    return _URL_RE.sub(_verbalize_url, text)


def _plural_unit(unit: str, plural: bool) -> str:
    if not plural:
        return unit
    # "mile per hour" pluralizes the head noun
    if " per " in unit:
        head, _, tail = unit.partition(" per ")
        return _plural_unit(head, True) + " per " + tail
    return _UNIT_PLURAL_IRREGULAR.get(unit, unit + "s")


def _en_date(m) -> str:
    y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
    if not (1 <= mo <= 12 and 1 <= d <= 31):
        return m.group(0)
    return f"{_MONTHS[mo - 1]} {_ordinal_words(d)} {_year_words(y)}"


def _en_date_mdy(m) -> str:
    mo, d, y = int(m.group(1)), int(m.group(2)), int(m.group(3))
    if not (1 <= mo <= 12 and 1 <= d <= 31):
        return m.group(0)
    return f"{_MONTHS[mo - 1]} {_ordinal_words(d)} {_year_words(y)}"


def _en_time(m) -> str:
    h, mi = int(m.group(1)), int(m.group(2))
    sec, ap = m.group(3), m.group(4)
    if h > 23 or mi > 59:
        return m.group(0)
    out = _int_to_words(h)
    if mi == 0:
        out += "" if ap else " o'clock"
    elif mi < 10:
        out += " oh " + _ONES[mi]
    else:
        out += " " + _int_to_words(mi)
    if sec is not None:
        out += " and " + _int_to_words(int(sec)) + (
            " second" if int(sec) == 1 else " seconds")
    if ap:
        out += " " + (" ".join(ap.lower().replace(".", "")))
    return out


def _en_phone(m) -> str:
    digits = re.sub(r"\D", "", m.group(0))
    if len(digits) < 7:
        return m.group(0)  # short groups fall through to range/number rules
    groups = re.split(r"[-. ]", m.group(0).lstrip("+"))
    spoken = ", ".join(_digits_words(g) for g in groups if g)
    if m.group(0).startswith("+"):
        spoken = "plus " + spoken
    return spoken


def _en_currency(m) -> str:
    sym, amount, scale = m.group(1), m.group(2).replace(",", ""), m.group(3)
    unit, sub = _CURRENCY[sym]
    if scale:  # $3 million -> three million dollars
        return f"{_num_token_to_words(amount)} {scale} {unit}s"
    if "." in amount:
        whole_s, frac = amount.split(".", 1)
        whole = int(whole_s or 0)
        out = _int_to_words(whole) + " " + (unit if whole == 1 else unit + "s")
        if frac and int(frac) != 0:
            cents = int(frac[:2].ljust(2, "0"))
            sub_w = sub if cents == 1 else (
                "pennies" if sub == "penny" else sub + "s")
            out += " " + _int_to_words(cents) + " " + sub_w
        return out
    whole = int(amount)
    return _int_to_words(whole) + " " + (unit if whole == 1 else unit + "s")


_FRACTION_SPECIAL = {(1, 2): "one half", (1, 4): "one quarter",
                     (3, 4): "three quarters"}


def _en_fraction(m) -> str:
    a, b = int(m.group(1)), int(m.group(2))
    if b == 0:
        return m.group(0)
    if (a, b) in _FRACTION_SPECIAL:
        return _FRACTION_SPECIAL[(a, b)]
    denom = _ordinal_words(b)
    if a != 1:
        denom += "s"
    return f"{_int_to_words(a)} {denom}"


def _en_unit(m) -> str:
    num, unit = m.group(1), m.group(2).lower()
    name = _UNITS[unit]
    plural = num not in ("1", "1.0")
    return f"{_num_token_to_words(num)} {_plural_unit(name, plural)}"


def _en_degrees(m) -> str:
    num, scale = m.group(1), m.group(2)
    deg = "degree" if num == "1" else "degrees"
    suffix = {"C": " celsius", "F": " fahrenheit"}[scale]
    return f"{_num_token_to_words(num)} {deg}{suffix}"


def normalize_numbers(text: str) -> str:
    """Expand numeric patterns to words (English). Precedence: dates >
    times > phones > currency > long digit strings > percent > fractions >
    units > ordinals > year ranges > years > ranges > thousands-grouped >
    plain numbers. Emails/URLs are verbalized first so their digits and
    dots are not consumed by the numeric rules."""
    text = verbalize_emails_urls(text)
    text = re.sub(r"\b(\d{4})[/-](\d{1,2})[/-](\d{1,2})\b", _en_date, text)
    text = re.sub(r"\b(\d{1,2})/(\d{1,2})/(\d{4})\b", _en_date_mdy, text)
    text = re.sub(
        r"\b(\d{1,2}):(\d{2})(?::(\d{2}))?\s*([ap]\.?m\.?)?\b",
        _en_time, text, flags=re.IGNORECASE)
    # phone shapes only: leading + (international), >= 3 separated groups,
    # or the US 3-3-4 — a bare pair like "1980-1990" is a year range /
    # adjacent numbers, NOT a phone (it used to match here and be read as
    # digit strings)
    text = re.sub(
        r"(?<![\d\w])(?:\+\d{1,4}(?:[-. ]\d{2,4}){1,4}"
        r"|\d{1,4}(?:[-. ]\d{3,4}){2,3}"
        r"|\(\d{3}\)\s*\d{3}[-. ]\d{4}"
        r"|\d{3}[-.]\d{4})(?!\d)", _en_phone, text)
    text = re.sub(
        r"([$€£¥￥])([\d,]+(?:\.\d+)?)"
        r"(?:\s*(trillion|billion|million|thousand))?",
        _en_currency, text)
    # bare long digit strings (ids, account numbers) — after currency so
    # $1234567 reads as an amount, not digits with a stranded '$'
    text = re.sub(r"(?<!\d)(\d{7,})(?!\d)",
                  lambda m: _digits_words(m.group(1)), text)
    text = re.sub(r"(\d+(?:\.\d+)?)%",
                  lambda m: _num_token_to_words(m.group(1)) + " percent",
                  text)
    text = re.sub(r"\b(\d+)\s*/\s*(\d+)\b", _en_fraction, text)
    text = re.sub(r"\b(\d+(?:\.\d+)?)\s*°\s*([CF])\b", _en_degrees, text)
    text = re.sub(
        r"\b(\d+(?:\.\d+)?)\s*°",
        lambda m: _num_token_to_words(m.group(1)) +
        (" degree" if m.group(1) == "1" else " degrees"), text)
    unit_alt = "|".join(sorted(_UNITS, key=len, reverse=True))
    text = re.sub(rf"\b(\d+(?:\.\d+)?)\s?({unit_alt})\b", _en_unit, text,
                  flags=re.IGNORECASE)
    text = re.sub(r"\b[Nn]o\.\s*(\d+)",
                  lambda m: "number " + _int_to_words(int(m.group(1))), text)
    text = re.sub(r"\b(\d+)(?:st|nd|rd|th)\b",
                  lambda m: _ordinal_words(int(m.group(1))), text)
    # year ranges before single years, so "1980-1990" gets a spoken "to"
    text = re.sub(
        r"\b(1[1-9]\d{2}|20\d{2})\s*[-–]\s*(1[1-9]\d{2}|20\d{2})\b",
        lambda m: f"{_year_words(int(m.group(1)))} to "
                  f"{_year_words(int(m.group(2)))}", text)
    text = re.sub(r"\b(1[1-9]\d{2}|20\d{2})\b",
                  lambda m: _year_words(int(m.group(1))), text)
    text = re.sub(
        r"\b(\d+)\s*-\s*(\d+)\b",
        lambda m: f"{_int_to_words(int(m.group(1)))} to "
                  f"{_int_to_words(int(m.group(2)))}", text)
    text = re.sub(r"(^|[\s(])-(\d+(?:\.\d+)?)",
                  lambda m: m.group(1) + "minus " +
                  _num_token_to_words(m.group(2)), text)
    text = re.sub(r"\b\d{1,3}(?:,\d{3})+\b",
                  lambda m: _int_to_words(int(m.group(0).replace(",", ""))),
                  text)
    text = re.sub(r"\d+(?:\.\d+)?|\.\d+",
                  lambda m: _num_token_to_words(m.group(0)), text)
    return text


# ----------------------------------------------------------------- Chinese

_ZH_DIGITS = "零一二三四五六七八九"
_ZH_PHONE_DIGITS = "零幺二三四五六七八九"   # 幺 for 1 in phone numbers
_ZH_UNITS_SMALL = ["", "十", "百", "千"]
_ZH_UNITS_BIG = ["", "万", "亿", "万亿"]


def _zh_int_under_10k(n: int) -> str:
    """0..9999 with 零 padding rules (105 -> 一百零五)."""
    if n == 0:
        return "零"
    out = []
    need_zero = False
    for pos in range(3, -1, -1):
        d = (n // 10 ** pos) % 10
        if d == 0:
            if out:
                need_zero = True
            continue
        if need_zero:
            out.append("零")
            need_zero = False
        out.append(_ZH_DIGITS[d] + _ZH_UNITS_SMALL[pos])
    return "".join(out)


def _int_to_zh(n: int) -> str:
    """Value reading with 万/亿 grouping: 120034 -> 十二万零三十四."""
    if n < 0:
        return "负" + _int_to_zh(-n)
    if n == 0:
        return "零"
    groups = []          # base-10000 digits, little-endian
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    out = []
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if g == 0:
            continue
        # inter-group zero: a non-top group < 1000 means a skipped place
        if out and g < 1000:
            out.append("零")
        out.append(_zh_int_under_10k(g) + _ZH_UNITS_BIG[i])
    s = "".join(out)
    # 一十X -> 十X only at the very start (10..19)
    if s.startswith("一十"):
        s = s[1:]
    return s


def _zh_digits(digits: str, phone: bool = False) -> str:
    table = _ZH_PHONE_DIGITS if phone else _ZH_DIGITS
    return "".join(table[int(c)] for c in digits if c.isdigit())


def _zh_num_token(tok: str) -> str:
    if "." in tok:
        whole, frac = tok.split(".", 1)
        return (_int_to_zh(int(whole)) if whole else "零") + "点" + \
            _zh_digits(frac)
    # very long digit strings (ids, codes) read digit-by-digit
    if len(tok) > 8:
        return _zh_digits(tok)
    return _int_to_zh(int(tok))


def _zh_date(m) -> str:
    y, mo, d = m.group(1), int(m.group(2)), int(m.group(3))
    if not (1 <= mo <= 12 and 1 <= d <= 31):
        return m.group(0)
    return f"{_zh_digits(y)}年{_int_to_zh(mo)}月{_int_to_zh(d)}日"


def _zh_time(m) -> str:
    h, mi = int(m.group(1)), int(m.group(2))
    sec = m.group(3)
    if h > 23 or mi > 59:
        return m.group(0)
    out = _int_to_zh(h) + "点"
    if mi == 0 and sec is None:
        out += "整"
    elif mi > 0 or sec is not None:
        out += _int_to_zh(mi) + "分"
    if sec is not None:
        out += _int_to_zh(int(sec)) + "秒"
    return out


def zh_normalize_numbers(text: str) -> str:
    """Chinese TN for the reference normalizers' case families: dates,
    times, phones (幺), currency, percents, fractions, temperatures,
    ranges, decimals, value-reading cardinals, digit-string ids."""
    # emails/URLs first (read with English 'at'/'dot' loanwords)
    text = verbalize_emails_urls(text)
    # dates: 2024-01-05 / 2024/1/5 and bare year 2024年
    text = re.sub(r"(\d{4})[/-](\d{1,2})[/-](\d{1,2})", _zh_date, text)
    text = re.sub(r"(\d{2,4})年",
                  lambda m: _zh_digits(m.group(1)) + "年", text)
    # clock times
    text = re.sub(r"(\d{1,2}):(\d{2})(?::(\d{2}))?", _zh_time, text)
    # phone numbers: 11-digit mobile / grouped digits, 幺 reading
    text = re.sub(r"(?<!\d)(1[3-9]\d{9})(?!\d)",
                  lambda m: _zh_digits(m.group(1), phone=True), text)
    # grouped phones need >= 3 groups (or the 3-4 local shape): a bare
    # 4-4 pair like 1980-1990 is a range, not a phone
    text = re.sub(
        r"(?<!\d)(\d{3,4}(?:[- ]\d{3,4}){2,3}|\d{3}-\d{4})(?!\d)",
        lambda m: _zh_digits(re.sub(r"\D", "", m.group(1)), phone=True)
        if len(re.sub(r"\D", "", m.group(1))) >= 7 else m.group(0), text)
    # currency: ¥12.5 / $8 / 12.5元
    text = re.sub(r"[¥￥]\s*(\d+(?:\.\d+)?)",
                  lambda m: _zh_num_token(m.group(1)) + "元", text)
    text = re.sub(r"\$\s*(\d+(?:\.\d+)?)",
                  lambda m: _zh_num_token(m.group(1)) + "美元", text)
    # percent / permille
    text = re.sub(r"(\d+(?:\.\d+)?)%",
                  lambda m: "百分之" + _zh_num_token(m.group(1)), text)
    text = re.sub(r"(\d+(?:\.\d+)?)‰",
                  lambda m: "千分之" + _zh_num_token(m.group(1)), text)
    # fractions: 3/4 -> 四分之三
    text = re.sub(r"(\d+)\s*/\s*(\d+)",
                  lambda m: _int_to_zh(int(m.group(2))) + "分之" +
                  _int_to_zh(int(m.group(1))), text)
    # temperature
    text = re.sub(r"(\d+(?:\.\d+)?)\s*(?:°C|℃)",
                  lambda m: _zh_num_token(m.group(1)) + "摄氏度", text)
    # ranges: 5-10 -> 五到十 (after dates/phones consumed their dashes)
    text = re.sub(r"(?<!\d)(\d+)\s*[-~～]\s*(\d+)(?!\d)",
                  lambda m: _int_to_zh(int(m.group(1))) + "到" +
                  _int_to_zh(int(m.group(2))), text)
    # negatives
    text = re.sub(r"(^|[\s(（:：,，])-(\d+(?:\.\d+)?)",
                  lambda m: m.group(1) + "负" + _zh_num_token(m.group(2)),
                  text)
    # remaining numbers: value reading (digit-wise when very long)
    text = re.sub(r"\d+(?:\.\d+)?",
                  lambda m: _zh_num_token(m.group(0)), text)
    return text


def normalize_text(text: str, language: str = "en") -> str:
    """Full normalization entry point: number expansion + whitespace
    cleanup, per language."""
    if language == "zh":
        text = zh_normalize_numbers(text)
    else:
        text = normalize_numbers(text)
    return re.sub(r"\s+", " ", text).strip()
