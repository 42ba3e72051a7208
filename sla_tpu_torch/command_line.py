"""Table-driven command-line parser with the reference CLI's exact semantics
(reference: src/command_line_parser.c:173-331, spec struct
src/include/private/command_line_parser.h).

Supports short-option runs (``-edq``), long options with ``=`` or a following
argument, duplicate/unknown/missing-argument errors, and positional capture
into a bounded list. Option arguments may not begin with ``-``.
"""

from __future__ import annotations

import dataclasses
import enum
import sys


class ParserResult(enum.Enum):
    OK = 0
    INVALID_ARGUMENT = 1
    INVALID_SPECIFICATION = 2
    UNKNOWN_OPTION = 3
    OPTION_MULTIPLY_SPECIFIED = 4
    NOT_SPECIFY_ARGUMENT_TO_OPTION = 5
    INVALID_SHORT_OPTION_ARGUMENT = 6
    INSUFFICIENT_OTHER_STRING_ARRAY_SIZE = 7


@dataclasses.dataclass
class OptionSpec:
    """One row of the option table."""

    short_option: str  # single char, or "" for long-only
    long_option: str | None
    need_argument: bool
    description: str
    # parse results:
    argument_string: str | None = None
    acquired: bool = False


def _check_specification(specs: list[OptionSpec]) -> bool:
    """Duplicate short/long names make the table invalid
    (CommandLineParser_CheckSpecification)."""
    shorts = [s.short_option for s in specs if s.short_option]
    longs = [s.long_option for s in specs if s.long_option]
    return len(shorts) == len(set(shorts)) and len(longs) == len(set(longs))


def _find_spec(specs: list[OptionSpec], option_name: str) -> OptionSpec | None:
    """Single-char names match short options first, then long options."""
    if len(option_name) == 1:
        for s in specs:
            if s.short_option == option_name:
                return s
    for s in specs:
        if s.long_option == option_name:
            return s
    return None


def get_option_acquired(specs: list[OptionSpec], option_name: str) -> bool:
    s = _find_spec(specs, option_name)
    return bool(s and s.acquired)


def get_argument_string(specs: list[OptionSpec], option_name: str) -> str | None:
    s = _find_spec(specs, option_name)
    return s.argument_string if s else None


def print_description(specs: list[OptionSpec], file=None) -> None:
    """Auto help text (CommandLineParser_PrintDescription semantics)."""
    file = file or sys.stdout
    for s in specs:
        short = f"-{s.short_option}" if s.short_option else "  "
        long_ = f"--{s.long_option}" if s.long_option else ""
        arg = " <arg>" if s.need_argument else ""
        print(f"  {short}, {long_}{arg}  {s.description}", file=file)


def parse_arguments(
    specs: list[OptionSpec],
    argv: list[str],
    positional: list[str | None],
    err=None,
) -> ParserResult:
    """Parse argv (argv[0] is the program name) against the spec table.

    Positional (non-option) strings fill `positional` in order; overflow is
    an error. Mirrors CommandLineParser_ParseArguments exactly, including
    the rule that option arguments may not start with '-'.
    """
    err = err or sys.stderr
    prog = argv[0] if argv else "?"
    if not _check_specification(specs):
        return ParserResult.INVALID_SPECIFICATION
    for s in specs:
        s.acquired = False
        s.argument_string = None

    pos_index = 0
    count = 1
    while count < len(argv):
        arg = argv[count]
        if arg.startswith("--"):
            matched = None
            for s in specs:
                if s.long_option is None:
                    continue
                body = arg[2:]
                if not body.startswith(s.long_option):
                    continue
                rest = body[len(s.long_option):]
                if rest == "":
                    if s.acquired:
                        print(f'{prog}: Option "{s.long_option}" multiply specified.', file=err)
                        return ParserResult.OPTION_MULTIPLY_SPECIFIED
                    if s.need_argument:
                        if count + 1 == len(argv) or argv[count + 1].startswith("-"):
                            print(f'{prog}: Option "{s.long_option}" needs argument.', file=err)
                            return ParserResult.NOT_SPECIFY_ARGUMENT_TO_OPTION
                        count += 1
                        s.argument_string = argv[count]
                elif rest.startswith("="):
                    if not s.need_argument:
                        continue  # maybe another option containing '='
                    if s.acquired:
                        print(f'{prog}: Option "{s.long_option}" multiply specified.', file=err)
                        return ParserResult.OPTION_MULTIPLY_SPECIFIED
                    s.argument_string = rest[1:]
                else:
                    continue  # longer name; a different option may match
                s.acquired = True
                matched = s
                break
            if matched is None:
                print(f'{prog}: Unknown long option - "{arg[2:]}"', file=err)
                return ParserResult.UNKNOWN_OPTION
        elif arg.startswith("-"):
            # a bare "-" enters the short-option branch and its character
            # loop runs zero times — the reference parser silently consumes
            # it (command_line_parser.c short-run loop), so it is NOT a
            # positional argument here either
            i = 1
            while i < len(arg):
                ch = arg[i]
                spec = None
                for s in specs:
                    if s.short_option == ch:
                        spec = s
                        break
                if spec is None:
                    print(f"{prog}: Unknown short option - '{ch}'", file=err)
                    return ParserResult.UNKNOWN_OPTION
                if spec.acquired:
                    print(f"{prog}: Option '{ch}' multiply specified.", file=err)
                    return ParserResult.OPTION_MULTIPLY_SPECIFIED
                if spec.need_argument:
                    if i + 1 != len(arg):
                        # an arg-taking option must end the run
                        print(
                            f"{prog}: Option '{ch}' needs argument. "
                            "Please specify tail of short option sequence.",
                            file=err,
                        )
                        return ParserResult.INVALID_SHORT_OPTION_ARGUMENT
                    if count + 1 == len(argv) or argv[count + 1].startswith("-"):
                        print(f"{prog}: Option '{ch}' needs argument.", file=err)
                        return ParserResult.NOT_SPECIFY_ARGUMENT_TO_OPTION
                    count += 1
                    spec.argument_string = argv[count]
                spec.acquired = True
                i += 1
        else:
            if pos_index >= len(positional):
                print(f"{prog}: Too many strings specified.", file=err)
                return ParserResult.INSUFFICIENT_OTHER_STRING_ARRAY_SIZE
            positional[pos_index] = arg
            pos_index += 1
        count += 1
    return ParserResult.OK
