// Native tokenizer hot loops of superllama_tpu_torch: SPM greedy bigram
// merge and BPE rank merge (the semantics of llama.cpp's llm_tokenizer_spm
// and llm_tokenizer_bpe). The Python paths of tokenizer/tokenizer.py stay
// the plain version: these must give the same ids (tests hold them equal).
//
// Build (native/__init__.py does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC tokenizer.cpp
// ABI: plain C, ctypes-friendly.

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct SpmVocab {
    std::unordered_map<std::string, int32_t> token_to_id;  // last wins
    std::vector<float> scores;
    std::vector<uint8_t> is_normal;
    int32_t byte_tokens[256];
    int32_t unk_id;
};

struct BpeVocab {
    std::unordered_map<std::string, int32_t> token_to_id;
    std::unordered_map<std::string, int32_t> merge_rank;  // "left right"
};

// one UTF-8 character length from lead byte (mirrors tokenizer.py sym_start)
inline int utf8_len(uint8_t b) {
    return b < 0x80 ? 1 : (b < 0xE0 ? 2 : (b < 0xF0 ? 3 : 4));
}

struct Bigram {
    float negscore;  // SPM: -score; BPE: rank
    int32_t left;
    int32_t bsize;
};
// pop order must equal python heapq on (negscore, left, bsize)
struct BigramGreater {
    bool operator()(const Bigram & a, const Bigram & b) const {
        if (a.negscore != b.negscore) return a.negscore > b.negscore;
        if (a.left != b.left) return a.left > b.left;
        return a.bsize > b.bsize;
    }
};
using BigramHeap =
    std::priority_queue<Bigram, std::vector<Bigram>, BigramGreater>;

}  // namespace

extern "C" {

// ---------------------------------------------------------------- SPM

void * slt_spm_new(const char * blob, const int64_t * offsets,
                   const float * scores, const uint8_t * is_normal, int32_t n,
                   const int32_t * byte_tokens, int32_t unk_id) {
    auto * v = new SpmVocab();
    v->scores.assign(scores, scores + n);
    v->is_normal.assign(is_normal, is_normal + n);
    v->unk_id = unk_id;
    std::memcpy(v->byte_tokens, byte_tokens, 256 * sizeof(int32_t));
    v->token_to_id.reserve(n * 2);
    for (int32_t i = 0; i < n; ++i) {
        std::string tok(blob + offsets[i], blob + offsets[i + 1]);
        v->token_to_id[tok] = i;  // last occurrence wins (vocab.py)
    }
    return v;
}

void slt_spm_free(void * h) { delete static_cast<SpmVocab *>(h); }

int32_t slt_spm_encode(void * h, const char * text, int64_t len,
                       int32_t * out, int32_t max_out) {
    const auto & v = *static_cast<SpmVocab *>(h);
    const uint8_t * data = reinterpret_cast<const uint8_t *>(text);
    if (len == 0) return 0;

    std::vector<int64_t> sym_start;
    for (int64_t i = 0; i < len;) {
        sym_start.push_back(i);
        i += utf8_len(data[i]);
        if (i > len) i = len;
    }
    const int32_t n_sym = (int32_t) sym_start.size();
    std::vector<int64_t> size(n_sym);
    for (int32_t k = 0; k < n_sym; ++k)
        size[k] = (k + 1 < n_sym ? sym_start[k + 1] : len) - sym_start[k];
    std::vector<int32_t> prev(n_sym), nxt(n_sym);
    for (int32_t k = 0; k < n_sym; ++k) { prev[k] = k - 1; nxt[k] = k + 1; }
    nxt[n_sym - 1] = -1;

    std::unordered_map<std::string, std::pair<int32_t, int32_t>> rev_merge;
    BigramHeap heap;

    auto try_add = [&](int32_t left, int32_t right) {
        if (left < 0 || right < 0 || right >= n_sym) return;
        std::string txt((const char *) data + sym_start[left],
                        (const char *) data + sym_start[right] + size[right]);
        auto it = v.token_to_id.find(txt);
        if (it == v.token_to_id.end()) return;
        int32_t tid = it->second;
        if (!v.is_normal[tid]) return;
        heap.push({-v.scores[tid], left, (int32_t) txt.size()});
    };
    for (int32_t k = 0; k + 1 < n_sym; ++k) try_add(k, k + 1);

    while (!heap.empty()) {
        Bigram bg = heap.top();
        heap.pop();
        int32_t left = bg.left, right = nxt[left];
        if (size[left] == 0 || right < 0 || size[right] == 0 ||
            size[left] + size[right] != bg.bsize)
            continue;
        std::string merged((const char *) data + sym_start[left],
                           (const char *) data + sym_start[left] + bg.bsize);
        rev_merge[merged] = {left, right};
        size[left] += size[right];
        size[right] = 0;
        nxt[left] = nxt[right];
        if (nxt[right] >= 0) prev[nxt[right]] = left;
        try_add(prev[left], left);
        try_add(left, nxt[left]);
    }

    int32_t n_out = 0;
    auto emit = [&](int32_t tid) {
        if (n_out < max_out) out[n_out] = tid;
        ++n_out;
    };
    // resegment (tokenizer.py resegment, mirrored exactly): spans are read
    // from the CURRENT sym_start/size tables by symbol index
    std::vector<int32_t> st2;
    int32_t k = 0;
    while (k != -1 && k < n_sym) {
        if (size[k] > 0) {
            st2.clear();
            st2.push_back(k);
            while (!st2.empty()) {
                int32_t s = st2.back();
                st2.pop_back();
                std::string txt((const char *) data + sym_start[s],
                                (const char *) data + sym_start[s] + size[s]);
                auto it = v.token_to_id.find(txt);
                if (it != v.token_to_id.end()) {
                    emit(it->second);
                    continue;
                }
                auto rm = rev_merge.find(txt);
                if (rm == rev_merge.end()) {
                    for (int64_t j = 0; j < size[s]; ++j) {
                        int32_t bt =
                            v.byte_tokens[(uint8_t) data[sym_start[s] + j]];
                        emit(bt >= 0 ? bt : v.unk_id);
                    }
                    continue;
                }
                st2.push_back(rm->second.second);  // right after left
                st2.push_back(rm->second.first);
            }
        }
        k = nxt[k];
    }
    return n_out;
}

// ---------------------------------------------------------------- BPE

void * slt_bpe_new(const char * tok_blob, const int64_t * tok_off, int32_t n_tok,
                   const char * merge_blob, const int64_t * merge_off,
                   int32_t n_merge) {
    auto * v = new BpeVocab();
    v->token_to_id.reserve(n_tok * 2);
    for (int32_t i = 0; i < n_tok; ++i)
        v->token_to_id[std::string(tok_blob + tok_off[i],
                                   tok_blob + tok_off[i + 1])] = i;
    v->merge_rank.reserve(n_merge * 2);
    for (int32_t i = 0; i < n_merge; ++i) {
        std::string m(merge_blob + merge_off[i], merge_blob + merge_off[i + 1]);
        v->merge_rank[m] = i;  // last wins, like the python dict comprehension
    }
    return v;
}

void slt_bpe_free(void * h) { delete static_cast<BpeVocab *>(h); }

// enc: utf-8 byte-encoded word (gpt2 byte→unicode already applied by caller)
int32_t slt_bpe_encode_word(void * h, const char * enc, int64_t len,
                            int32_t * out, int32_t max_out) {
    const auto & v = *static_cast<BpeVocab *>(h);
    const uint8_t * data = reinterpret_cast<const uint8_t *>(enc);
    if (len == 0) return 0;

    std::vector<int64_t> sym_start;
    for (int64_t i = 0; i < len;) {
        sym_start.push_back(i);
        i += utf8_len(data[i]);
        if (i > len) i = len;
    }
    const int32_t n_sym = (int32_t) sym_start.size();
    // size in CHARACTERS (python counts chars); byte extents tracked separately
    std::vector<int32_t> size(n_sym, 1);
    std::vector<int64_t> bend(n_sym);
    for (int32_t k = 0; k < n_sym; ++k)
        bend[k] = (k + 1 < n_sym) ? sym_start[k + 1] : len;
    std::vector<int32_t> prev(n_sym), nxt(n_sym);
    for (int32_t k = 0; k < n_sym; ++k) { prev[k] = k - 1; nxt[k] = k + 1; }
    nxt[n_sym - 1] = -1;

    BigramHeap heap;
    auto txt = [&](int32_t k) {
        return std::string((const char *) data + sym_start[k],
                           (const char *) data + bend[k]);
    };
    auto try_add = [&](int32_t left, int32_t right) {
        if (left < 0 || right < 0) return;
        if (size[left] == 0 || size[right] == 0) return;
        std::string key = txt(left) + " " + txt(right);
        auto it = v.merge_rank.find(key);
        if (it == v.merge_rank.end()) return;
        heap.push({(float) it->second, left, size[left] + size[right]});
    };
    for (int32_t k = 0; k + 1 < n_sym; ++k) try_add(k, k + 1);

    while (!heap.empty()) {
        Bigram bg = heap.top();
        heap.pop();
        int32_t left = bg.left, right = nxt[left];
        if (size[left] == 0 || right < 0 || size[right] == 0 ||
            size[left] + size[right] != bg.bsize)
            continue;
        size[left] += size[right];
        bend[left] = bend[right];
        size[right] = 0;
        nxt[left] = nxt[right];
        if (nxt[right] >= 0) prev[nxt[right]] = left;
        try_add(prev[left], left);
        try_add(left, nxt[left]);
    }

    int32_t n_out = 0;
    auto emit = [&](int32_t tid) {
        if (n_out < max_out) out[n_out] = tid;
        ++n_out;
    };
    int32_t k = 0;
    while (k >= 0 && k < n_sym) {
        if (size[k] > 0) {
            std::string part = txt(k);
            auto it = v.token_to_id.find(part);
            if (it != v.token_to_id.end()) {
                emit(it->second);
            } else {
                // per-character fallback (tokenizer.py _bpe_tokenize)
                for (int64_t i = 0; i < (int64_t) part.size();) {
                    int l = utf8_len((uint8_t) part[i]);
                    if (i + l > (int64_t) part.size()) l = part.size() - i;
                    auto ch = v.token_to_id.find(part.substr(i, l));
                    if (ch != v.token_to_id.end()) emit(ch->second);
                    i += l;
                }
            }
        }
        k = nxt[k];
    }
    return n_out;
}

}  // extern "C"
