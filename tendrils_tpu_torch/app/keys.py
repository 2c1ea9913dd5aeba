"""Keyboard performance map — ref `keyMash()`, `demo.main.js:3326-3589`.

A client UI forwards key events to `KeyMash.key_down/key_up`; the maps are
the reference's two layouts (performance by default, editor with
`editor_keys`): number/letter keys fire presets or select a state field,
arrows adjust the held field, release records a keyframe.

A copy of `tendrils_tpu/app/keys.py` (pure Python; importing that package
imports JAX).
"""



def _state_num(demo, key, scale):
    return {
        "reset": lambda: demo.state.update(
            {key: demo.default_state[key]}),
        "adjust": lambda by: demo.state.update(
            {key: demo.state[key] + scale * by}),
    }


def _state_bool(demo, key):
    return {
        "reset": lambda: demo.state.update(
            {key: demo.default_state[key]}),
        "go": lambda: demo.state.update({key: not demo.state[key]}),
    }


class KeyMash:
    def __init__(self, demo):
        self.demo = demo
        self.editing = {}
        self.edit_map = self._make_edit_map() if \
            demo.app_settings["editorKeys"] else {}
        self.call_map = self._make_call_map()

    # -- maps

    def _make_edit_map(self):
        """Editor layout — ref `demo.main.js:3392-3434`."""
        d = self.demo
        return {
            "`": {
                "reset": lambda: (d.tendrils.setup(
                    d.default_state["rootNum"]), d.restart()),
                "adjust": lambda by: (d.tendrils.setup(
                    int(d.state["rootNum"] * 2 ** by)), d.restart()),
            },
            "P": _state_bool(d, "autoClearView"),
            "Q": _state_num(d, "forceWeight", 0.01),
            "A": _state_num(d, "flowWeight", 0.02),
            "W": _state_num(d, "noiseWeight", 0.0002),
            "S": _state_num(d, "flowDecay", 0.005),
            "D": _state_num(d, "flowWidth", 1),
            "E": _state_num(d, "noiseScale", 1),
            "R": _state_num(d, "noiseSpeed", 0.002),
            "Z": _state_num(d, "damping", 0.001),
            "X": _state_num(d, "speedLimit", 0.0001),
            "N": _state_num(d, "speedAlpha", 0.002),
            "M": _state_num(d, "lineWidth", 0.1),
        }

    def _make_call_map(self):
        """Performance layout — ref `demo.main.js:3497-3545` (editor variant
        `demo.main.js:3437-3495`)."""
        d = self.demo
        p = d.presets
        if d.app_settings["editorKeys"]:
            out = {
                "O": lambda: d.clear(),
                "1": p["Flow"], "2": p["Wings"], "3": p["Fluid"],
                "4": p["Frequencies"], "5": p["Ghostly"], "6": p["Rave"],
                "7": p["Blood"], "8": p["Turbulence"], "9": p["Funhouse"],
                "0": p["Noise Only"],
                "-": lambda: self._adjust_each(-0.1),
                "=": lambda: self._adjust_each(0.1),
                "<down>": lambda: self._adjust_each(-1),
                "<up>": lambda: self._adjust_each(1),
                "<left>": lambda: self._adjust_each(-5),
                "<right>": lambda: self._adjust_each(5),
                "<escape>": lambda: self._reset_each(),
                "<space>": lambda: setattr(d, "track_playing",
                                           not d.track_playing),
                "<enter>": lambda: d.keyframe(),
                "\\": lambda: d.reset(),
                "'": lambda: d.spawn_flow(),
                ";": lambda: d.spawn_fastest(),
                ",": lambda: d.spawn_form(),
                "<shift>": lambda: d.restart(),
                "/": lambda: d.spawn_samples(),
                ".": lambda: d.spawn_image_targets(),
            }
        else:
            out = {
                "1": p["Flow"], "2": p["Wings"], "3": p["Fluid"],
                "4": p["Frequencies"], "5": p["Ghostly"], "6": p["Rave"],
                "7": p["Blood"], "8": p["Turbulence"], "9": p["Funhouse"],
                "0": p["Noise Only"], "-": p["Flow Only"],
                "Q": p["Folding"], "W": p["Rorschach"], "E": p["Starlings"],
                "R": p["Sea"], "T": p["Kelp Forest"],
                "Y": p["Tornado Alley"], "U": p["Pop Tide"],
                "I": p["Narcissus Pool"], "O": p["Minimal"],
                "P": p["Pissarides"],
                "D": p["AZ:D:Dark"], "L": p["AZ:L:Light"],
                "G": p["AZ:G:Green"],
                "J": p["H:J:Flow"], "Z": p["H:Z:Folding"],
                "X": p["H:X:Starlings"], "C": p["H:C:Kelp Forest"],
                "V": p["H:V:Tornado Alley"], "B": p["H:B:Pop Tide"],
                "N": p["H:N:Narcissus Pool"], "M": p["H:M:Pissarides"],
                "<space>": lambda: d.restart(),
                "'": lambda: d.spawn_flow(),
                ";": lambda: d.spawn_fastest(),
                ",": lambda: d.spawn_form(),
                "<shift>": lambda: d.restart(),
                "/": lambda: d.spawn_samples(),
                ".": lambda: d.spawn_image_targets(),
                "\\": lambda: d.clear(),
                "`": lambda: d.state.update(
                    autoClearView=not d.state["autoClearView"]),
            }
        return out

    def _adjust_each(self, by):
        for x in self.editing.values():
            if x and x.get("adjust"):
                x["adjust"](by)

    def _reset_each(self):
        for x in self.edit_map.values():
            if x.get("reset"):
                x["reset"]()

    # -- event handling (ref demo.main.js:3553-3589)

    def key_down(self, key):
        mapped = self.edit_map.get(key)
        call = self.call_map.get(key)
        if mapped is not None and key not in self.editing:
            self.editing[key] = mapped
            if mapped.get("go"):
                mapped["go"]()
            return True
        if call is not None:
            call()
            return True
        return False

    def key_up(self, key):
        mapped = self.edit_map.get(key)
        if mapped is not None and key in self.editing:
            # Record a keyframe of the tweaked state on release.
            self.demo.keyframe(dict(self.demo.state))
            del self.editing[key]
            return True
        return key in self.call_map
