"""audio_s_per_s: every second of audio the window's calls returned, at
its realized length, over the window's wall time (from the first call's
send to the last call's return). Host clock."""


def read(run):
    calls = run.record.get("calls")
    if not calls or not run.window_s:
        return None
    samples = sum(sum(c["samples"]) for c in calls)
    return samples / run.cfg["data"]["sampling_rate"] / run.window_s
