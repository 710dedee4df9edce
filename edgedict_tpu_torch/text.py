"""Text normalization (counterpart of edgedict_tpu/text.py, a copy: the
reference parts/text surface, parts/text/cleaners.py:62-107,
parts/text/numbers.py:33-99).

english_cleaners: ASCII transliteration, lowercasing, abbreviation
expansion, number expansion (dollars, decimals, ordinals, years, plain
numbers), whitespace collapse.  The reference used the `inflect` package
for number→words; here it is a small self-contained converter.
"""

import re
import unicodedata

_ABBREVIATIONS = [(re.compile(r'\b%s\.' % abbr, re.IGNORECASE), full)
                  for abbr, full in [
    ('mrs', 'misess'), ('mr', 'mister'), ('dr', 'doctor'),
    ('st', 'saint'), ('co', 'company'), ('jr', 'junior'),
    ('maj', 'major'), ('gen', 'general'), ('drs', 'doctors'),
    ('rev', 'reverend'), ('lt', 'lieutenant'), ('hon', 'honorable'),
    ('sgt', 'sergeant'), ('capt', 'captain'), ('esq', 'esquire'),
    ('ltd', 'limited'), ('col', 'colonel'), ('ft', 'fort')]]

_ONES = ['', 'one', 'two', 'three', 'four', 'five', 'six', 'seven',
         'eight', 'nine', 'ten', 'eleven', 'twelve', 'thirteen',
         'fourteen', 'fifteen', 'sixteen', 'seventeen', 'eighteen',
         'nineteen']
_TENS = ['', '', 'twenty', 'thirty', 'forty', 'fifty', 'sixty',
         'seventy', 'eighty', 'ninety']
_SCALE = [(10 ** 9, 'billion'), (10 ** 6, 'million'), (1000, 'thousand'),
          (100, 'hundred')]
_ORDINAL_IRREGULAR = {
    'one': 'first', 'two': 'second', 'three': 'third', 'five': 'fifth',
    'eight': 'eighth', 'nine': 'ninth', 'twelve': 'twelfth'}


def number_to_words(n):
    """Non-negative integer → english words."""
    n = int(n)
    if n == 0:
        return 'zero'
    parts = []
    for value, name in _SCALE:
        if n >= value:
            parts.append(number_to_words(n // value))
            parts.append(name)
            n %= value
    if n >= 20:
        if n % 10:
            parts.append(_TENS[n // 10] + ' ' + _ONES[n % 10])
        else:
            parts.append(_TENS[n // 10])
    elif n > 0:
        parts.append(_ONES[n])
    return ' '.join(parts)


def ordinal_to_words(n):
    words = number_to_words(n)
    head, _, last = words.rpartition(' ')
    if last in _ORDINAL_IRREGULAR:
        last = _ORDINAL_IRREGULAR[last]
    elif last.endswith('y'):
        last = last[:-1] + 'ieth'
    else:
        last = last + 'th'
    return (head + ' ' + last).strip()


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split('.')
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1][:2].ljust(2, '0')) if len(parts) > 1 and parts[1] \
        else 0
    out = []
    if dollars:
        out.append(number_to_words(dollars))
        out.append('dollar' if dollars == 1 else 'dollars')
    if cents:
        out.append(number_to_words(cents))
        out.append('cent' if cents == 1 else 'cents')
    return ' '.join(out) if out else 'zero dollars'


def _expand_decimal(m):
    whole, frac = m.group(1), m.group(2)
    digits = ' '.join(number_to_words(int(d)) for d in frac)
    return f'{number_to_words(int(whole))} point {digits}'


def _expand_year(n):
    """1984 → nineteen eighty four (reference numbers.py year handling)."""
    if n % 100 == 0:
        return number_to_words(n)
    hi, lo = divmod(n, 100)
    if lo < 10:
        return f'{number_to_words(hi)} oh {number_to_words(lo)}'
    return f'{number_to_words(hi)} {number_to_words(lo)}'


def _expand_number(m):
    n = int(m.group(0))
    if 1000 < n < 3000:
        if n == 2000:
            return 'two thousand'
        if 2000 < n < 2010:
            return 'two thousand ' + number_to_words(n % 100)
        return _expand_year(n)
    return number_to_words(n)


def normalize_numbers(text):
    text = re.sub(r'([0-9][0-9,]*),([0-9]{3})', lambda m:
                  m.group(1).replace(',', '') + m.group(2), text)
    text = re.sub(r'\$([0-9.]+)', _expand_dollars, text)
    text = re.sub(r'£([0-9]+)', lambda m:
                  number_to_words(int(m.group(1))) + ' pounds', text)
    text = re.sub(r'([0-9]+)\.([0-9]+)', _expand_decimal, text)
    text = re.sub(r'([0-9]+)(st|nd|rd|th)', lambda m:
                  ordinal_to_words(int(m.group(1))), text)
    text = re.sub(r'[0-9]+', _expand_number, text)
    return text


def convert_to_ascii(text):
    return unicodedata.normalize('NFKD', text) \
        .encode('ascii', 'ignore').decode('ascii')


def expand_abbreviations(text):
    for pattern, full in _ABBREVIATIONS:
        text = pattern.sub(full, text)
    return text


def collapse_whitespace(text):
    return re.sub(r'\s+', ' ', text).strip()


def english_cleaners(text):
    """The reference's full English pipeline (parts/text/cleaners.py:95+)."""
    text = convert_to_ascii(text)
    text = text.lower()
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)
