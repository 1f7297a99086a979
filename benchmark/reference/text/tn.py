"""Text normalization (Chinese).

Behavioral parity target: the reference wraps WeTextProcessing's FST
tagger/verbalizer and degrades to identity when built without it
(runtime/core/frontend/tn.h:26-46). Here: a rule-based normalizer covering
the WeTextProcessing-documented categories — cardinals, decimals, negative
numbers, percentages, fractions, ranges, money, measure units, ordinals,
dates (年/月/日 and ISO), times, digit-string readings (phone-like
sequences), and 二/两 measure-word selection — falling back to identity
elsewhere. The API matches the reference's TN class
(`normalize(text) -> text`). Conventions (e.g. 两个 but 第二, 幺 in phone
numbers, 百分之 before the number) follow WeTextProcessing's verbalizers;
`tests/test_tn.py` carries the transcribed golden table.

The benchmark's frozen copy of the port's `text/tn.py`, part of its
reference; it imports nothing of the program.
"""

from __future__ import annotations

import re

_DIGITS = "零一二三四五六七八九"
_UNITS = ["", "十", "百", "千"]
_GROUP_UNITS = ["", "万", "亿", "万亿"]

# measure words / classifiers after which a standalone "2" reads 两
# (WeTextProcessing measure semantics: 2个 -> 两个, 2元 -> 两元, but
# 12个 -> 十二个 and 第2 -> 第二)
_CLASSIFIERS = (
    # NB: 月/日/号 deliberately absent — "2月" is 二月 (February), not 两月
    "个只条张本位名人次件套间瓶杯块岁倍元角分斤两秒天年点"
    "千克克千米米厘米毫米毫升升摄氏度"
)

# number + latin unit suffix -> Chinese unit reading (longest match first)
_UNIT_TABLE = [
    ("km/h", "千米每小时"),
    ("m/s", "米每秒"),
    ("kwh", "千瓦时"),
    ("kw", "千瓦"),
    ("khz", "千赫兹"),
    ("mhz", "兆赫兹"),
    ("hz", "赫兹"),
    ("kg", "千克"),
    ("mg", "毫克"),
    ("km", "千米"),
    ("cm", "厘米"),
    ("mm", "毫米"),
    ("ml", "毫升"),
    ("°c", "摄氏度"),
    ("℃", "摄氏度"),
]


def _read_group(n: int) -> str:
    """Read 0 <= n < 10000 in Mandarin (no group unit)."""
    if n == 0:
        return ""
    out = []
    need_zero = False
    for i in range(3, -1, -1):
        d = (n // 10**i) % 10
        if d == 0:
            if out:
                need_zero = True
            continue
        if need_zero:
            out.append(_DIGITS[0])
            need_zero = False
        out.append(_DIGITS[d] + _UNITS[i])
    return "".join(out)


def number_to_chinese(n: int) -> str:
    """Cardinal reading of a non-negative integer."""
    if n == 0:
        return _DIGITS[0]
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    out = []
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if g == 0:
            continue
        piece = _read_group(g)
        # inter-group zero: 一亿零一 style
        if i < len(groups) - 1 and groups[i + 1] != 0 and g < 1000:
            piece = _DIGITS[0] + piece
        out.append(piece + _GROUP_UNITS[i])
    text = "".join(out)
    # 一十X -> 十X (10..19)
    if text.startswith("一十"):
        text = text[1:]
    return text


def digits_to_chinese(s: str) -> str:
    """Digit-by-digit reading (phone numbers, IDs); 1 -> 幺."""
    mapping = {"0": "零", "1": "幺", "2": "二", "3": "三", "4": "四",
               "5": "五", "6": "六", "7": "七", "8": "八", "9": "九"}
    return "".join(mapping.get(c, c) for c in s)


def decimal_to_chinese(int_part: str, frac_part: str) -> str:
    frac = "".join(_DIGITS[int(c)] for c in frac_part)
    return number_to_chinese(int(int_part)) + "点" + frac


def _read_number(s: str) -> str:
    """Read an unsigned integer or decimal literal."""
    if "." in s:
        ip, fp = s.split(".", 1)
        return decimal_to_chinese(ip or "0", fp)
    return number_to_chinese(int(s))


class TextNormalizer:
    """Rule-based CN text normalization with identity fallback."""

    _NUM = r"\d+(?:\.\d+)?"
    _RE_PCT_RANGE = re.compile(rf"({_NUM})%?\s*[-~]\s*({_NUM})%")
    _RE_PERCENT = re.compile(rf"(-?)({_NUM})%")
    _RE_ISO_DATE = re.compile(r"(\d{4})[-/](\d{1,2})[-/](\d{1,2})日?")
    _RE_YEAR_RANGE = re.compile(r"(\d{4})\s*[-~]\s*(\d{4})年")
    # years read digit-by-digit only in the calendar range 1000-2999
    # ("5000年" is a duration -> cardinal 五千年, the WeTextProcessing
    # date/number disambiguation)
    _RE_YEAR = re.compile(r"([12]\d{3})年")
    _RE_DATE = re.compile(r"(\d{1,2})月(\d{1,3})([日号])")
    _RE_TIME_RANGE = re.compile(
        r"(\d{1,2}:\d{2}(?::\d{2})?)\s*[-~]\s*(?=\d{1,2}:\d{2})")
    _RE_TIME = re.compile(r"(\d{1,2}):(\d{2})(?::(\d{2}))?")
    _RE_FRACTION = re.compile(r"(?<![\d/.])(\d+)/(\d+)(?![\d/.])")
    _RE_RANGE = re.compile(rf"(?<![\d.])({_NUM})\s*[-~]\s*({_NUM})(?![\d.])")
    _RE_MONEY = re.compile(rf"[¥￥]\s*({_NUM})")
    _RE_DOLLAR = re.compile(rf"\$\s*({_NUM})")
    _RE_UNIT = re.compile(
        rf"({_NUM})\s*({'|'.join(re.escape(u) for u, _ in _UNIT_TABLE)})"
        r"(?![a-z])", re.IGNORECASE)
    # telephone shapes only (a bare 7+-digit cardinal like 1000000 must
    # stay a cardinal): CN mobile 1[3-9]xxxxxxxxx, area-code landline
    # 0xx(x)-xxxxxxx(x), long 0-leading digit strings
    _RE_TEL = re.compile(r"(?<!\d)(0\d{2,3})-(\d{7,8})(?!\d)")
    _RE_PHONE = re.compile(r"(?<!\d)(?:1[3-9]\d{9}|0\d{9,11})(?!\d)")
    # not after a decimal point: the fractional digits of 5.05 belong to
    # the decimal rule, not the digit-string rule
    _RE_LEADING_ZERO = re.compile(r"(?<![\d.])0\d+")
    _RE_NEG = re.compile(rf"-({_NUM})")
    _RE_DECIMAL = re.compile(r"(\d+)\.(\d+)")
    _RE_TWO = re.compile(rf"(?<!\d)(?<!第)2(?=[{_CLASSIFIERS}])")
    _RE_INT = re.compile(r"\d+")

    def normalize(self, text: str) -> str:
        text = self._RE_PCT_RANGE.sub(self._pct_range, text)
        text = self._RE_PERCENT.sub(self._percent, text)
        text = self._RE_ISO_DATE.sub(self._iso_date, text)
        text = self._RE_YEAR_RANGE.sub(self._year_range, text)
        text = self._RE_YEAR.sub(self._year, text)
        text = self._RE_DATE.sub(self._date, text)
        text = self._RE_TIME_RANGE.sub(lambda m: m.group(1) + "到", text)
        text = self._RE_TIME.sub(self._time, text)
        text = self._RE_FRACTION.sub(self._fraction, text)
        text = self._RE_UNIT.sub(self._unit, text)
        text = self._RE_MONEY.sub(lambda m: self._two_sel(
            m.group(1), "元") + "元", text)
        text = self._RE_DOLLAR.sub(lambda m: self._two_sel(
            m.group(1), "美") + "美元", text)
        text = self._RE_TEL.sub(
            lambda m: digits_to_chinese(m.group(1) + m.group(2)), text)
        text = self._RE_PHONE.sub(lambda m: digits_to_chinese(m.group(0)),
                                  text)
        text = self._RE_RANGE.sub(self._range, text)
        text = self._RE_LEADING_ZERO.sub(
            lambda m: digits_to_chinese(m.group(0)), text)
        text = self._RE_NEG.sub(
            lambda m: "负" + _read_number(m.group(1)), text)
        text = self._RE_DECIMAL.sub(
            lambda m: decimal_to_chinese(m.group(1), m.group(2)), text)
        text = self._RE_TWO.sub("两", text)
        text = self._RE_INT.sub(
            lambda m: number_to_chinese(int(m.group(0))), text)
        return text

    # -- helpers -----------------------------------------------------

    @staticmethod
    def _two_sel(num: str, following: str) -> str:
        """Read `num`, with 2 -> 两 before a classifier (两元, 两千克)."""
        if num == "2" and following and following[0] in (_CLASSIFIERS + "美"):
            return "两"
        return _read_number(num)

    @classmethod
    def _pct_range(cls, m):
        return ("百分之" + _read_number(m.group(1)) + "到百分之"
                + _read_number(m.group(2)))

    @staticmethod
    def _percent(m):
        sign = "负" if m.group(1) else ""
        return sign + "百分之" + _read_number(m.group(2))

    @staticmethod
    def _fraction(m):
        # WeTextProcessing fraction order: denominator 分之 numerator
        return (number_to_chinese(int(m.group(2))) + "分之"
                + number_to_chinese(int(m.group(1))))

    @staticmethod
    def _range(m):
        return _read_number(m.group(1)) + "到" + _read_number(m.group(2))

    @staticmethod
    def _year_range(m):
        return ("".join(_DIGITS[int(c)] for c in m.group(1)) + "到"
                + "".join(_DIGITS[int(c)] for c in m.group(2)) + "年")

    @classmethod
    def _unit(cls, m):
        reading = dict(_UNIT_TABLE)[m.group(2).lower()]
        return cls._two_sel(m.group(1), reading) + reading

    @staticmethod
    def _iso_date(m):
        return ("".join(_DIGITS[int(c)] for c in m.group(1)) + "年"
                + number_to_chinese(int(m.group(2))) + "月"
                + number_to_chinese(int(m.group(3))) + "日")

    @staticmethod
    def _year(m):
        return "".join(_DIGITS[int(c)] for c in m.group(1)) + "年"

    @staticmethod
    def _date(m):
        return (number_to_chinese(int(m.group(1))) + "月"
                + number_to_chinese(int(m.group(2))) + m.group(3))

    @staticmethod
    def _time(m):
        out = number_to_chinese(int(m.group(1))) + "点"
        minute = int(m.group(2))
        if minute:
            # 8:05 -> 八点零五分 (zero-padded single-digit minutes)
            if minute < 10:
                out += _DIGITS[0]
            out += number_to_chinese(minute) + "分"
        if m.group(3) and int(m.group(3)):
            out += number_to_chinese(int(m.group(3))) + "秒"
        return out
