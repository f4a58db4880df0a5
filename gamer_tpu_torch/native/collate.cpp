// Native data-plane kernels for the host-side batch pipeline.
//
// The per-step hot path of training is batch collation: gathering N ragged
// int32 example streams into fixed-shape padded matrices plus label masking
// (data/batching.py). The reference does this in per-example Python
// inside torch DataLoader workers (ref SeqRec/datasets/collator.py); here the
// inner loops are C++ with a C ABI consumed via ctypes (no pybind11 in the
// image). Built by native/__init__.py with g++ -O3 on first use.
//
// Layout convention: `flat` holds the concatenation of all rows; `offsets`
// (n+1 entries) delimits row r as flat[offsets[r]:offsets[r+1]].

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Right- or left-aligned padding of ragged rows into out[n][cols].
// Rows are passed as a pointer array (no host-side concatenation needed).
void pad_rows_i32(int32_t* out, int64_t n, int64_t cols,
                  const int32_t** rows, const int64_t* lens,
                  int32_t pad_value, int32_t left_align) {
    for (int64_t r = 0; r < n; ++r) {
        int64_t len = lens[r] > cols ? cols : lens[r];
        int32_t* row = out + r * cols;
        std::fill(row, row + cols, pad_value);
        if (left_align) {
            std::memcpy(row, rows[r], len * sizeof(int32_t));
        } else {
            std::memcpy(row + (cols - len), rows[r], len * sizeof(int32_t));
        }
    }
}

// int64 rows -> int32 padded matrix (example streams are int64 in numpy).
void pad_rows_i64_to_i32(int32_t* out, int64_t n, int64_t cols,
                         const int64_t** rows, const int64_t* lens,
                         int32_t pad_value, int32_t left_align) {
    for (int64_t r = 0; r < n; ++r) {
        int64_t len = lens[r] > cols ? cols : lens[r];
        int32_t* row = out + r * cols;
        std::fill(row, row + cols, pad_value);
        int32_t* dst = left_align ? row : row + (cols - len);
        const int64_t* src = rows[r];
        for (int64_t c = 0; c < len; ++c) dst[c] = (int32_t)src[c];
    }
}

// float64 rows -> float32 padded matrix (time streams).
void pad_rows_f64_to_f32(float* out, int64_t n, int64_t cols,
                         const double** rows, const int64_t* lens,
                         float pad_value, int32_t left_align) {
    for (int64_t r = 0; r < n; ++r) {
        int64_t len = lens[r] > cols ? cols : lens[r];
        float* row = out + r * cols;
        std::fill(row, row + cols, pad_value);
        float* dst = left_align ? row : row + (cols - len);
        const double* src = rows[r];
        for (int64_t c = 0; c < len; ++c) dst[c] = (float)src[c];
    }
}

// Decoder-only label masking (ref collator.py:68-77): copy ids, set pads and
// behavior tokens to ignore_label; optionally mask the prompt region.
// behavior_sorted: ascending token ids; prompt_lens[r] < 0 -> no prompt mask.
void mask_labels_i32(int32_t* labels, const int32_t* input_ids,
                     int64_t n, int64_t cols,
                     const int32_t* attention, // same shape, 1 = real
                     const int32_t* behavior_sorted, int64_t n_behavior,
                     const int64_t* prompt_lens,
                     int32_t ignore_label) {
    for (int64_t r = 0; r < n; ++r) {
        const int32_t* ids = input_ids + r * cols;
        const int32_t* att = attention + r * cols;
        int32_t* lab = labels + r * cols;
        int64_t prompt = prompt_lens[r];
        for (int64_t c = 0; c < cols; ++c) {
            int32_t tok = ids[c];
            bool is_behavior = std::binary_search(
                behavior_sorted, behavior_sorted + n_behavior, tok);
            if (!att[c] || is_behavior || (prompt >= 0 && c < prompt)) {
                lab[c] = ignore_label;
            } else {
                lab[c] = tok;
            }
        }
    }
}

// Per-token stream expansion (ref SMB_dataset.py:194-234): repeat each event
// value token_count times into out (already sized n_events * tc).
void repeat_stream_i64(int64_t* out, const int64_t* values, int64_t n_events,
                       int64_t tc) {
    for (int64_t e = 0; e < n_events; ++e) {
        int64_t v = values[e];
        int64_t* dst = out + e * tc;
        for (int64_t t = 0; t < tc; ++t) dst[t] = v;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Arena collation: the dataset's streams live in flat arrays built once
// (ExampleStore in native/__init__.py); a batch is collated with ONE call per
// field — no per-row Python/ctypes marshalling.
// ---------------------------------------------------------------------------

extern "C" {

// Gather example rows `indices` from the arena and pad to out[B][cols].
void gather_pad_i64_to_i32(int32_t* out, int64_t batch, int64_t cols,
                           const int64_t* flat, const int64_t* offsets,
                           const int64_t* indices,
                           int32_t pad_value, int32_t left_align) {
    for (int64_t b = 0; b < batch; ++b) {
        int64_t e = indices[b];
        int64_t len = offsets[e + 1] - offsets[e];
        if (len > cols) len = cols;
        int32_t* row = out + b * cols;
        std::fill(row, row + cols, pad_value);
        int32_t* dst = left_align ? row : row + (cols - len);
        const int64_t* src = flat + offsets[e];
        for (int64_t c = 0; c < len; ++c) dst[c] = (int32_t)src[c];
    }
}

void gather_pad_f64_to_f32(float* out, int64_t batch, int64_t cols,
                           const double* flat, const int64_t* offsets,
                           const int64_t* indices,
                           float pad_value, int32_t left_align) {
    for (int64_t b = 0; b < batch; ++b) {
        int64_t e = indices[b];
        int64_t len = offsets[e + 1] - offsets[e];
        if (len > cols) len = cols;
        float* row = out + b * cols;
        std::fill(row, row + cols, pad_value);
        float* dst = left_align ? row : row + (cols - len);
        const double* src = flat + offsets[e];
        for (int64_t c = 0; c < len; ++c) dst[c] = (float)src[c];
    }
}

}  // extern "C"
