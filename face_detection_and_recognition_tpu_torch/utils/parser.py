"""Shared CLI argument parser.

The port's copy of ``utils/parser.py`` in the JAX package (the reference's
``modules/utils/parser.py``): ``-i/--input_src``, ``--md/--model``,
``--dt/--det_thres`` (0.70), ``--at/--bbox_area_thres`` (0.12),
``-d/--device``, ``-o/--output`` and ``--no-display``. ``-d`` takes ``cuda``
(the default: the card) or ``cpu``.
"""
from __future__ import annotations

import argparse
from typing import List


class ArgumentParserMod(argparse.ArgumentParser):
    """argparse with argument removal, so entry points can edit the shared
    base parser."""

    def remove_argument(self, arg: str) -> None:
        """Drop the flag whose dest (or first option string) is ``arg``
        from this parser and from every action group that displays it."""
        doomed = [a for a in self._actions
                  if a.dest == arg
                  or (a.option_strings and a.option_strings[0] == arg)]
        for action in doomed:
            self._remove_action(action)
            for group in self._action_groups:
                if action in group._group_actions:
                    group._group_actions.remove(action)
            # argparse routes option strings through _option_string_actions:
            # without this the removed flag still parses, and adding it
            # again conflicts
            for opt in action.option_strings:
                self._option_string_actions.pop(opt, None)

    def remove_arguments(self, args: List[str]) -> None:
        for a in args:
            self.remove_argument(a)


def add_device_flag(parser: argparse.ArgumentParser,
                    flags=("-d", "--device")) -> None:
    """The device flag of the port's CLIs: ``cuda`` (the default: the
    card) or ``cpu``."""
    parser.add_argument(
        *flags, dest="device", default="cuda", choices=["cuda", "cpu"],
        help="Device to inference on. (default: %(default)s)")


def get_argparse(*args, **kwargs) -> ArgumentParserMod:
    parser = ArgumentParserMod(*args, **kwargs)
    parser.add_argument(
        "-i", "--input_src", default="0", dest="input_src",
        help="Media source: an image path, a video path, or a webcam index "
             "(e.g. -i 0 opens the default camera). (default: %(default)s)")
    parser.add_argument(
        "--md", "--model", dest="model", default="yolov5s",
        help="Detector name from the registry. (default: %(default)s)")
    parser.add_argument(
        "--dt", "--det_thres", dest="det_thres", type=float, default=0.70,
        help="Minimum detection confidence; boxes at or below this score "
             "are dropped. (default: %(default)s)")
    parser.add_argument(
        "--at", "--bbox_area_thres", dest="bbox_area_thres", type=float,
        default=0.12,
        help="Minimum box size as a percentage of the frame area "
             "(100*box/frame); smaller boxes are dropped. "
             "(default: %(default)s)")
    add_device_flag(parser)
    parser.add_argument(
        "-o", "--output", dest="output", default=None,
        help="Write the annotated image here (JPEG).")
    parser.add_argument(
        "--no-display", dest="no_display", action="store_true",
        help="Do not open a window (the port has none: required).")
    return parser
