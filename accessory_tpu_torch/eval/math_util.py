"""MATH benchmark answer normalization and equivalence.

A copy of ``accessory_tpu/eval/math_util.py`` (framework-free; the port
keeps its own copy). Role of the reference's light-eval/src/eval_utils/
math_util.py (the standard Hendrycks-MATH string protocol): extract the last
\\boxed{...} group from a solution, normalize LaTeX surface forms
(fractions, sqrt, units, spacing), and compare normalized strings for
equivalence.
"""

from __future__ import annotations

import re
from typing import Optional


def last_boxed_only_string(string: str) -> Optional[str]:
    """Return the last ``\\boxed{...}`` (or ``\\fbox{...}``) substring,
    with braces balanced."""
    idx = string.rfind("\\boxed")
    if idx < 0:
        idx = string.rfind("\\fbox")
        if idx < 0:
            return None
    depth = 0
    end = None
    for i in range(idx, len(string)):
        if string[i] == "{":
            depth += 1
        elif string[i] == "}":
            depth -= 1
            if depth == 0:
                end = i
                break
    if end is None:
        return None
    return string[idx: end + 1]


def remove_boxed(s: Optional[str]) -> Optional[str]:
    if s is None:
        return None
    for left in ("\\boxed{", "\\fbox{"):
        if s.startswith(left) and s.endswith("}"):
            return s[len(left):-1]
    return None


def _fix_fracs(string: str) -> str:
    """\\frac12 -> \\frac{1}{2}; \\frac1{2} -> \\frac{1}{2}."""
    parts = string.split("\\frac")
    out = parts[0]
    for p in parts[1:]:
        if p.startswith("{"):
            out += "\\frac" + p
            continue
        if len(p) >= 2:
            a, b, rest = p[0], p[1], p[2:]
            if b == "{":
                out += f"\\frac{{{a}}}{b}{rest}"
            else:
                out += f"\\frac{{{a}}}{{{b}}}{rest}"
        else:
            out += "\\frac" + p
    return out


def _fix_a_slash_b(string: str) -> str:
    """a/b with integer a, b -> \\frac{a}{b}."""
    if string.count("/") != 1:
        return string
    a, b = string.split("/")
    try:
        ia, ib = int(a), int(b)
        return f"\\frac{{{ia}}}{{{ib}}}"
    except ValueError:
        return string


def _remove_right_units(string: str) -> str:
    """Drop trailing ``\\text{ units}`` annotations."""
    if "\\text{ " in string:
        return string.split("\\text{ ")[0].rstrip()
    return string


def _fix_sqrt(string: str) -> str:
    """\\sqrt3 -> \\sqrt{3}."""
    return re.sub(r"\\sqrt(?!\{)(.)", r"\\sqrt{\1}", string)


def strip_string(string: str) -> str:
    """Normalize a MATH answer string (reference strip_string protocol)."""
    s = string.replace("\n", "")
    s = s.replace("\\!", "")
    s = s.replace("\\\\", "\\")
    s = s.replace("tfrac", "frac").replace("dfrac", "frac")
    s = s.replace("\\left", "").replace("\\right", "")
    s = s.replace("^{\\circ}", "").replace("^\\circ", "")
    s = s.replace("\\$", "")
    s = _remove_right_units(s)
    s = s.replace("\\%", "").replace("%", "")
    # " .5" / ".5" -> "0.5"
    s = s.replace(" .", " 0.")
    if s.startswith("."):
        s = "0" + s
    # strip lhs of a simple equation ("x = 5" -> "5")
    if len(s.split("=")) == 2 and len(s.split("=")[0].strip()) <= 2:
        s = s.split("=")[1]
    s = _fix_sqrt(s)
    s = s.replace(" ", "")
    s = _fix_fracs(s)
    if s == "0.5":
        s = "\\frac{1}{2}"
    s = _fix_a_slash_b(s)
    return s


def is_equiv(str1: Optional[str], str2: Optional[str]) -> bool:
    if str1 is None and str2 is None:
        return True
    if str1 is None or str2 is None:
        return False
    try:
        return strip_string(str1) == strip_string(str2)
    except Exception:
        return str1 == str2


def extract_math_answer(completion: str) -> Optional[str]:
    """Reference eval_math.extract_ans: cut at the next 'Problem:', take the
    text after 'answer is ', trim trailing period."""
    split_ans = re.split("Problem:", completion, flags=re.IGNORECASE)[0]
    split_ans = re.split("answer is ", split_ans, flags=re.IGNORECASE)
    if len(split_ans) <= 1:
        # fall back to a boxed answer inside the completion
        return remove_boxed(last_boxed_only_string(completion))
    ans = split_ans[-1].split(".\n")[0].strip()
    if ans.endswith("."):
        ans = ans[:-1]
    return ans.strip()
