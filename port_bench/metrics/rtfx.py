"""rtfx (audio-s/s): the audio seconds of every batch completed in the
window over the window's wall seconds (the Open ASR Leaderboard's RTFx)."""


def read(run):
    done = [r for r in run.calls if not run.driver.failed(r)]
    return sum(r.audio_s for r in done) / run.window_s
