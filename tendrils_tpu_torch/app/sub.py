"""Scroll-driven embed variant — ref `src/sub.main.js` (226 LoC).

The reference observes DOM sections annotated with `data-tendrils-preset` /
`data-tendrils-trigger` and, as they scroll into view, switches presets (the
most-visible section wins) and fires trigger controls on their configured
delay schedules (`sub.main.js:128-161`). This headless port keeps the same
selection semantics over abstract sections with a visibility ratio supplied
by the host (a web client, a timeline, a test).

A copy of `tendrils_tpu/app/sub.py` (pure Python; importing that package
imports JAX).
"""


class Section:
    def __init__(self, preset=None, trigger=None):
        self.preset = preset
        self.trigger = trigger
        self.ratio = 0.0  # visibility [0, 1]


class SubSequencer:
    """Preset/trigger switching by section visibility."""

    # Per-trigger fire-time schedules (ms offsets) — `triggerTimes` analog.
    DEFAULT_TRIGGER_TIMES = {"def": [0.0]}

    def __init__(self, demo, sections=None, trigger_times=None):
        self.demo = demo
        self.sections = list(sections or [])
        self.trigger_times = dict(self.DEFAULT_TRIGGER_TIMES,
                                  **(trigger_times or {}))
        self.preset = None
        self.pending = []  # (fire_time_ms, control_name)

    def add_section(self, preset=None, trigger=None):
        sec = Section(preset, trigger)
        self.sections.append(sec)
        return sec

    def observe(self, ratios, now=0.0):
        """Update visibility ratios (list parallel to sections) and react —
        the IntersectionObserver callback analog (`sub.main.js:129-158`)."""
        best = None
        for sec, r in zip(self.sections, ratios):
            was = sec.ratio
            sec.ratio = r
            intersecting = r > 0
            if not intersecting:
                continue
            if sec.trigger and was <= 0:
                times = self.trigger_times.get(
                    sec.trigger, self.trigger_times["def"])
                for t in times:
                    self.pending.append((now + t, sec.trigger))
            if sec.preset and (best is None or r > best.ratio):
                best = sec

        if best is not None and best.preset != self.preset:
            self.preset = best.preset
            self.demo.apply_preset(best.preset)
        return self

    def tick(self, now):
        """Fire due triggers (the setTimeout analog)."""
        due = [c for t, c in self.pending if t <= now]
        self.pending = [(t, c) for t, c in self.pending if t > now]
        controls = self.demo.controls
        for name in due:
            if name in controls:
                controls[name]()
        return self
