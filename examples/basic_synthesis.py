"""Basic synthesis: default voice → WAV file."""

from vietvoice_tts_tpu import TTSApi

api = TTSApi()
generation_time = api.synthesize_to_file(
    "Xin chào! Đây là hệ thống tổng hợp giọng nói tiếng Việt chạy trên GPU.",
    "output/basic.wav",
)
print(f"Done in {generation_time:.2f}s → output/basic.wav")
