"""Warning helpers of the skimage layer (skimage._shared._warnings):
``warn``, and the test helpers ``all_warnings`` and
``expected_warnings``."""

from contextlib import contextmanager
import os
import re
import warnings

__all__ = ["all_warnings", "expected_warnings", "warn"]


def warn(message, category=UserWarning, stacklevel=2):
    """``warnings.warn`` with skimage's defaults."""
    warnings.warn(message, category=category, stacklevel=stacklevel)


@contextmanager
def all_warnings():
    """Context that records every warning, raised always (the filters
    are restored on exit)."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        yield w


@contextmanager
def expected_warnings(matching):
    r"""Context for tests that expect warnings matching the regexes in
    ``matching``; ``None`` in the list makes all warnings optional, and
    ``"\A\Z"`` an empty match.  With ``SKIMAGE_TEST_STRICT_WARNINGS``
    true (the default), an unexpected warning or a missing expected one
    raises ValueError."""
    if isinstance(matching, str):
        raise ValueError("``matching`` should be a list of strings and not "
                         "a string itself.")
    strict_warnings = os.environ.get("SKIMAGE_TEST_STRICT_WARNINGS", "1")
    if strict_warnings.lower() == "true":
        strict_warnings = True
    elif strict_warnings.lower() == "false":
        strict_warnings = False
    else:
        strict_warnings = bool(int(strict_warnings))

    with all_warnings() as w:
        yield w
        if "|\\A\\Z" in "|".join(m for m in matching if m is not None):
            remaining = []
        else:
            remaining = [m for m in matching
                         if m is not None and "\\A\\Z" not in m]
        for warn_rec in w:
            found = False
            for match in matching:
                if match is None:
                    found = True
                    continue
                if re.search(match, str(warn_rec.message)) is not None:
                    found = True
                    if match in remaining:
                        remaining.remove(match)
            if strict_warnings and not found:
                raise ValueError(
                    f"Unexpected warning: {str(warn_rec.message)}")
        if strict_warnings and (len(remaining) > 0):
            newline = "\n"
            msg = f"No warning raised matching:{newline}"
            msg += newline.join(remaining)
            raise ValueError(msg)
